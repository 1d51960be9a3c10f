"""Parameter-free statistical noise suppressor (decision-directed Wiener).

The same gain rule as the JAX package's ``models/mmse.py``: a tracked noise
PSD, a decision-directed a-priori SNR estimate, and a Wiener gain with a
spectral floor. It needs no trained weights, so it serves as a quality
floor for the learned model and as a deterministic enhancer for tests.

Everything is elementwise over [*, K] bins in plain PyTorch: the JAX version
runs outside any Pallas kernel, so this one has no kernel either. The state
is O(1) per stream, so the engine's masked commit and reset apply as they do
to the GRU model.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..constants import NUM_BINS
from .base import Placeholder

DEFAULT_CONFIG = {
    "kind": "mmse",
    "bins": NUM_BINS,
    "dd_beta": 0.96,       # decision-directed smoothing
    "noise_alpha": 0.92,   # noise PSD smoothing when speech is absent
    "gain_floor": 0.03,
    "init_frames": 6.0,    # fast noise adaptation horizon at stream start
}

# SNRs are clipped to a physical range: beyond ~60 dB the gain is saturated
# anyway, and unbounded values make the recurrent state chaotic.
_SNR_CAP = 1e6

MMSE = Params = Placeholder         # one unused placeholder leaf


def init_params(key=None, config: Dict[str, Any] = None) -> MMSE:
    return MMSE()


def init_state(batch_shape: Tuple[int, ...], config: Dict[str, Any], device):
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    device = torch.device(device)
    shape = tuple(batch_shape) + (cfg["bins"],)
    return {
        "noise": torch.full(shape, 1e-8, device=device),
        "prev_gain2_post": torch.zeros(shape, device=device),
        "count": torch.zeros(tuple(batch_shape), device=device),
    }


def step(params, state, re, im, config: Dict[str, Any] = None):
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    power = re * re + im * im
    noise = state["noise"]
    count = state["count"]

    # fast adaptation over the first frames (the stream head is taken as the
    # noise reference), then the steady-state smoothing constant
    boot = torch.clamp(1.0 / (count + 1.0), 1.0 - cfg["noise_alpha"], 1.0)[..., None]

    gamma = torch.clamp(power / torch.clamp(noise, min=1e-10), 0.0, _SNR_CAP)
    xi = (cfg["dd_beta"] * state["prev_gain2_post"]
          + (1.0 - cfg["dd_beta"]) * torch.clamp(gamma - 1.0, min=0.0))  # a-priori SNR
    xi = torch.clamp(xi, 0.0, _SNR_CAP)
    gain = xi / (1.0 + xi)                                          # Wiener rule

    # the speech-presence probability xi / (1 + xi) gates noise updates; its
    # complement is computed as 1 / (1 + xi) (1 - presence cancels for large xi)
    rate = boot / (1.0 + xi)
    new_noise = torch.clamp(noise + rate * (power - noise), min=1e-10)

    mask = torch.clamp(gain, min=cfg["gain_floor"])
    new_state = {
        "noise": new_noise,
        "prev_gain2_post": torch.clamp(gain * gain * gamma, 0.0, _SNR_CAP),
        "count": count + 1.0,
    }
    return new_state, mask


def apply_sequence(params, state, re, im, config: Dict[str, Any] = None):
    """Spectra [*, T, K] -> (final_state, masks [*, T, K]): a loop over T."""
    t_axis = re.dim() - 2
    masks = []
    for t in range(re.shape[t_axis]):
        state, mask = step(params, state, re.select(t_axis, t), im.select(t_axis, t), config)
        masks.append(mask)
    return state, torch.stack(masks, dim=t_axis)


__all__ = ["DEFAULT_CONFIG", "MMSE", "Params", "init_params", "init_state", "step",
           "apply_sequence"]
