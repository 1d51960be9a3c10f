"""Plain reference of the `mmse` model kind over whole streams.

A decision-directed Wiener suppressor (Ephraim and Malah's a-priori SNR
estimate, a Wiener gain with a floor), per bin of each hop's spectrum:

    p     = re^2 + im^2
    gamma = clip(p / max(noise, 1e-10), 0, 1e6)                 a-posteriori SNR
    xi    = clip(beta * prev + (1 - beta) * max(gamma - 1, 0), 0, 1e6)
    gain  = xi / (1 + xi);   mask = max(gain, gain_floor)
    noise = max(noise + clip(1 / (count + 1), 1 - alpha, 1) / (1 + xi) * (p - noise), 1e-10)
    prev  = clip(gain^2 gamma, 0, 1e6);   count = count + 1

from noise = 1e-8, prev = 0, count = 0 at a stream's start. The spectral
products run in `spectral` precision with float32 sums; the rest is float32.
"""

from __future__ import annotations

import torch

from .stft import BINS, bases, frames_of, overlap_add, prod

CAP = 1e6


@torch.no_grad()
def enhance(cfg, hops: torch.Tensor, spectral: str) -> torch.Tensor:
    """hops [B, T, 256] float32 of fresh streams -> enhanced hops [B, T, 256]."""
    fwd, inv = bases(hops.device)
    spec = prod(frames_of(hops), fwd, spectral)
    re, im = spec[..., :BINS], spec[..., BINS:]
    power = re * re + im * im
    beta, alpha = cfg["dd_beta"], cfg["noise_alpha"]
    noise = torch.full_like(power[:, 0], 1e-8)
    prev = torch.zeros_like(noise)
    masks = []
    for t in range(power.shape[1]):
        p = power[:, t]
        boot = min(max(1.0 / (t + 1.0), 1.0 - alpha), 1.0)
        gamma = torch.clamp(p / torch.clamp(noise, min=1e-10), 0.0, CAP)
        xi = torch.clamp(beta * prev + (1.0 - beta) * torch.clamp(gamma - 1.0, min=0.0), 0.0, CAP)
        gain = xi / (1.0 + xi)
        noise = torch.clamp(noise + boot / (1.0 + xi) * (p - noise), min=1e-10)
        prev = torch.clamp(gain * gain * gamma, 0.0, CAP)
        masks.append(torch.clamp(gain, min=cfg["gain_floor"]))
    mask = torch.stack(masks, dim=1)
    synth = prod(torch.cat([re * mask, im * mask], dim=-1), inv, spectral)
    return overlap_add(synth)


class Reference:
    """The suppressor of a configuration file (no weights)."""

    def __init__(self, config, model_path, device):
        self.cfg = dict(config["model"])

    def enhance(self, hops, precision, fused_hops=0):
        return enhance(self.cfg, hops, precision["spectral"])
