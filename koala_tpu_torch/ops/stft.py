"""STFT analysis / iSTFT overlap-add synthesis in PyTorch.

The same geometry and bases as the JAX package's ``ops/stft.py``: a 512-point
real DFT written as matmuls against cos/sin bases built in float64 numpy,
hop 256, sqrt-Hann window folded into the bases. Perfect reconstruction with
a delay of exactly one hop.

The matmuls run in true float32 through ``kernels.rowmm.matmul``: on a card
the fixed-order kernel (csrc/rowmm.cu), whose rows have the same bits in a
call of one frame and of many, so the one-hop step path and the sequence
path agree bit for bit (on the CPU its plain version); wherever autograd
records a graph (training), ``torch.matmul``, which on a card is true
float32 only while ``torch.backends.cuda.matmul.allow_tf32`` stays False
(PyTorch's default).
The forward transform keeps two separate matmuls for re and im, and the
inverse two products and an add, as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import FFT_SIZE, FRAME_LENGTH
from .kernels.rowmm import matmul


@functools.lru_cache(maxsize=None)
def _numpy_basis(fft_size: int):
    """Forward/inverse real-DFT bases, built in float64 then cast.

    Forward:  re = x @ FWD_RE,  im = x @ FWD_IM          (FWD_* : [N, K])
    Inverse:  x = re @ INV_RE + im @ INV_IM              (INV_* : [K, N])
    with weights 1 for k in {0, N/2} and 2 otherwise.
    """
    n = np.arange(fft_size)[:, None].astype(np.float64)
    k = np.arange(fft_size // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / fft_size
    fwd_re = np.cos(ang)
    fwd_im = -np.sin(ang)
    coef = np.full((fft_size // 2 + 1,), 2.0)
    coef[0] = 1.0
    coef[-1] = 1.0
    inv_re = (coef[:, None] * np.cos(ang).T) / fft_size
    inv_im = (coef[:, None] * -np.sin(ang).T) / fft_size
    return (
        fwd_re.astype(np.float32),
        fwd_im.astype(np.float32),
        inv_re.astype(np.float32),
        inv_im.astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _numpy_window(fft_size: int):
    n = np.arange(fft_size).astype(np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / fft_size)
    return np.sqrt(hann).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _windowed_bases(fft_size: int):
    """(fwd [N, 2K] = window-folded [cos | -sin], inv_re/inv_im [K, N]
    window-folded). All folds are computed in float64 before the f32 cast."""
    n = np.arange(fft_size)[:, None].astype(np.float64)
    k = np.arange(fft_size // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / fft_size
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(fft_size) / fft_size)
    w = np.sqrt(hann)
    fwd = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * w[:, None]
    coef = np.full((fft_size // 2 + 1,), 2.0)
    coef[0] = 1.0
    coef[-1] = 1.0
    inv_re = (coef[:, None] * np.cos(ang).T) / fft_size * w[None, :]
    inv_im = (coef[:, None] * -np.sin(ang).T) / fft_size * w[None, :]
    return (fwd.astype(np.float32), inv_re.astype(np.float32),
            inv_im.astype(np.float32))


@functools.lru_cache(maxsize=16)
def _bases_on(fft_size: int, windowed: bool, device: torch.device):
    """(fwd_re, fwd_im, inv_re, inv_im) float32 tensors on ``device``."""
    k = fft_size // 2 + 1
    if windowed:
        fwd, inv_re, inv_im = _windowed_bases(fft_size)
        arrays = (fwd[:, :k], fwd[:, k:], inv_re, inv_im)
    else:
        arrays = _numpy_basis(fft_size)
    # made outside inference mode: a cached basis first asked for by a serving
    # call must still be usable in a graph that a trainer records later
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                     for a in arrays)


def dft_matrices(fft_size: int = FFT_SIZE, device="cpu"):
    """(fwd_re [N, K], fwd_im [N, K], inv_re [K, N], inv_im [K, N]) float32
    on ``device``: the unwindowed bases, as the JAX package's
    ``dft_matrices``."""
    return tuple(torch.tensor(a, device=torch.device(device)) for a in _numpy_basis(fft_size))


def analysis_window(fft_size: int = FFT_SIZE, device="cpu") -> torch.Tensor:
    """sqrt-Hann window used for both analysis and synthesis."""
    return torch.as_tensor(_numpy_window(fft_size), device=torch.device(device))


def stft_frame(frames: torch.Tensor, windowed: bool = True):
    """[..., FFT_SIZE] time frames -> (re, im) each [..., NUM_BINS]."""
    fwd_re, fwd_im, _, _ = _bases_on(frames.shape[-1], windowed, frames.device)
    return matmul(frames, fwd_re), matmul(frames, fwd_im)


def istft_frame(re: torch.Tensor, im: torch.Tensor, windowed: bool = True) -> torch.Tensor:
    """(re, im) [..., NUM_BINS] -> synthesis-windowed time frame [..., FFT_SIZE]."""
    fft_size = 2 * (re.shape[-1] - 1)
    _, _, inv_re, inv_im = _bases_on(fft_size, windowed, re.device)
    return matmul(re, inv_re) + matmul(im, inv_im)


def frame_signal(pcm: torch.Tensor, hop: int = FRAME_LENGTH,
                 fft_size: int = FFT_SIZE) -> torch.Tensor:
    """[..., T*hop] -> overlapping [..., T, fft_size] frames. Frame t covers
    samples [(t-1)*hop, (t+1)*hop): the first frame sees one hop of zeros,
    as a fresh stream does."""
    if fft_size != 2 * hop:
        raise ValueError("frame_signal assumes 50% overlap")
    t = pcm.shape[-1] // hop
    hops = pcm[..., : t * hop].reshape(pcm.shape[:-1] + (t, hop))
    prev = torch.cat(
        [torch.zeros(pcm.shape[:-1] + (1, hop), dtype=pcm.dtype, device=pcm.device),
         hops[..., :-1, :]], dim=-2)
    return torch.cat([prev, hops], dim=-1)


def overlap_add(frames: torch.Tensor, hop: int = FRAME_LENGTH) -> torch.Tensor:
    """[..., T, fft_size] synthesis frames -> [..., T*hop] stream (delayed by
    hop). The final half-frame tail is dropped, as the streaming engine keeps
    it in its overlap-add carry."""
    head = frames[..., :hop]
    tail = frames[..., hop:]
    prev_tail = torch.cat(
        [torch.zeros(frames.shape[:-2] + (1, hop), dtype=frames.dtype,
                     device=frames.device), tail[..., :-1, :]], dim=-2)
    return (head + prev_tail).reshape(frames.shape[:-2] + (-1,))


__all__ = ["analysis_window", "dft_matrices", "stft_frame", "istft_frame", "frame_signal",
           "overlap_add"]
