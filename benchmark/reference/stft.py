"""Plain short-time Fourier transform of the engine, and the rounding rules.

The engine's transform: 512-point real DFT, hop 256, a sqrt-Hann window on
analysis and on synthesis (folded into the bases in float64), overlap-add.
Frame t is [hop t-1 | hop t], the first seeing a hop of zeros; output hop t
is the head of synthesis frame t plus the tail of frame t-1, so the output
lags the input by exactly one hop (256 samples).

`rnd` rounds a product operand to the precision a product is stated in:
`float32` (as it is), `tf32` (10 mantissa bits, round to nearest),
`bfloat16`, or `float8` (e4m3 with one scale for the whole tensor, as fp8
inference quantises). Every product of the references is
`rnd(a) @ rnd(b)` summed in float32 with TF32 off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HOP = 256
FFT = 512
BINS = FFT // 2 + 1
F8_MAX = 448.0


def no_tf32():
    """float32 products in true float32 on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rnd(x: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "float32":
        return x
    if dtype == "bfloat16":
        return x.bfloat16().float()
    if dtype == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF        # round the 13 dropped bits to nearest
        return bits.view(torch.float32)
    if dtype == "float8":
        scale = x.abs().amax().clamp(min=1e-30) / F8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError("unknown precision %r" % dtype)


def prod(a: torch.Tensor, b: torch.Tensor, dtype: str) -> torch.Tensor:
    return rnd(a, dtype) @ rnd(b, dtype)


@functools.lru_cache(maxsize=None)
def _bases_np():
    n = np.arange(FFT, dtype=np.float64)[:, None]
    k = np.arange(BINS, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / FFT
    w = np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(FFT) / FFT))
    fwd = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * w[:, None]     # [512, 514]
    coef = np.full((BINS, 1), 2.0)
    coef[0] = coef[-1] = 1.0
    inv = np.concatenate([coef * np.cos(ang).T, coef * -np.sin(ang).T], axis=0) / FFT
    inv = inv * w[None, :]                                                      # [514, 512]
    return fwd.astype(np.float32), inv.astype(np.float32)


def bases(device):
    """(fwd [512, 514] = [re | im] columns, inv [514, 512]) float32."""
    fwd, inv = _bases_np()
    return torch.as_tensor(fwd, device=device), torch.as_tensor(inv, device=device)


def frames_of(hops: torch.Tensor) -> torch.Tensor:
    """hops [B, T, 256] of fresh streams -> analysis frames [B, T, 512]."""
    prev = torch.cat([torch.zeros_like(hops[:, :1]), hops[:, :-1]], dim=1)
    return torch.cat([prev, hops], dim=-1)


def overlap_add(synth: torch.Tensor) -> torch.Tensor:
    """synthesis frames [B, T, 512] -> output hops [B, T, 256]."""
    tails = torch.cat([torch.zeros_like(synth[:, :1, HOP:]), synth[:, :-1, HOP:]], dim=1)
    return synth[..., :HOP] + tails


def by_segments(fn, x: torch.Tensor, segments):
    """Apply fn(x[:, lo:hi], dtype) over hop ranges [(lo, hi, dtype)] of
    the time axis (1) and join the results: a product whose precision
    differs between hop ranges."""
    return torch.cat([fn(x[:, lo:hi], d) for lo, hi, d in segments if hi > lo], dim=1)
