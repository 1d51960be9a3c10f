"""Parameter-free statistical noise suppressor (decision-directed Wiener).

The same gain rule as the JAX package's ``models/mmse.py``: a tracked noise
PSD, a decision-directed a-priori SNR estimate, and a Wiener gain with a
spectral floor. It needs no trained weights, so it serves as a quality
floor for the learned model and as a deterministic enhancer for tests.

The rule is elementwise over [*, K] bins. ``step`` runs one frame of it as a
plain PyTorch chain (``ops/kernels/mmse.py`` ``gain_frame``); ``apply_sequence``
runs all T frames in one call of ``mmse_gain``, a CUDA kernel on a card
(csrc/mmse.cu; the JAX version is a ``lax.scan`` outside any Pallas kernel,
so it replaces none) and the loop of ``gain_frame`` on the CPU. The two give
the same bits, so a stream's output does not depend on how it was cut into
calls. The state is O(1) per stream, so the engine's masked commit and reset
apply as they do to the GRU model.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .. import profiling
from ..constants import NUM_BINS
from ..ops.kernels import mmse as kernel
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


def gain_rule(config):
    """The rule's scalars from a config: (dd_beta, noise_alpha, gain_floor,
    SNR cap), as ``gain_frame`` and ``mmse_gain`` take them."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    return cfg["dd_beta"], cfg["noise_alpha"], cfg["gain_floor"], _SNR_CAP


def step(params, state, re, im, config: Dict[str, Any] = None):
    noise, prev, count, mask = kernel.gain_frame(re, im, state["noise"],
                                                 state["prev_gain2_post"], state["count"],
                                                 *gain_rule(config))
    return {"noise": noise, "prev_gain2_post": prev, "count": count}, mask


def apply_sequence(params, state, re, im, config: Dict[str, Any] = None):
    """Spectra [*, T, K] -> (final_state, masks [*, T, K]): the leading shape
    flattened to N streams and the T frames in one ``mmse_gain`` call. Under a
    profiler it records the span ``mmse.gain`` (counts ``frames``, ``columns``
    = N x K, ``kernel``: the kernel's launches in it, 1 on a card, else 0)."""
    lead, (t_len, k) = tuple(re.shape[:-2]), re.shape[-2:]
    n = math.prod(lead)
    with profiling.counted_span("mmse.gain", lambda: kernel.launches, key="kernel",
                                frames=t_len, columns=n * k):
        noise, prev, count, mask = kernel.mmse_gain(
            re.reshape(n, t_len, k).contiguous(), im.reshape(n, t_len, k).contiguous(),
            state["noise"].reshape(n, k).contiguous(),
            state["prev_gain2_post"].reshape(n, k).contiguous(),
            state["count"].reshape(n).contiguous(), *gain_rule(config))
    new_state = {"noise": noise.reshape(lead + (k,)),
                 "prev_gain2_post": prev.reshape(lead + (k,)), "count": count.reshape(lead)}
    return new_state, mask.reshape(re.shape)


__all__ = ["DEFAULT_CONFIG", "MMSE", "Params", "init_params", "init_state", "gain_rule",
           "step", "apply_sequence"]
