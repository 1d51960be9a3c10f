"""The tail of Demucs's transposed convolutions: CUDA kernel and plain version.

A transposed convolution of kernel 8 and stride 4 over n input positions is
one product p [rows, n, 8 C] (``rowmm``), read as [rows, n, 2, 4, C]: input
position i makes output positions 4 i .. 4 i + 3 from its first half and
adds its second half to the next input position's. ``overlap_add`` finishes
it in one pass over p:

    out[:, 4 i + q] = round(relu(p[:, i, 0, q] + prev + bias) + skip[:, 4 i + q])
    prev            = p[:, i - 1, 1, q] (i > 0), carry[:, q] (i = 0)
    carry'          = p[:, n - 1, 1]

ReLU, the skip (the next level's) and the bf16 round (the next product's
operand) each where asked. On the card ``csrc/overlap.cu`` (each element one
thread, the same IEEE f32 operations in the same order); on the CPU, and as
the yardstick of the card tests, ``overlap_add_ref``: the PyTorch ops the
kernel stands for. It replaces no TPU kernel (the JAX package has no
Demucs).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import profiling
from . import _build

# launches of the kernel since the last reset
launches = 0

STRIDE = 4


def overlap_add_ref(p: torch.Tensor, carry: torch.Tensor, bias: torch.Tensor, relu: bool,
                    skip: Optional[torch.Tensor] = None,
                    round_out: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: p [rows, n, 2, 4, C], carry [rows, 4, C], bias [C],
    skip [rows, 4 n, C] or None -> (out [rows, 4 n, C], carry' [rows, 4, C])."""
    rows, n, _, s, c = p.shape
    out = torch.empty((rows, n, s, c), dtype=p.dtype, device=p.device)
    torch.add(p[:, 1:, 0], p[:, :-1, 1], out=out[:, 1:])
    torch.add(p[:, 0, 0], carry, out=out[:, 0])
    new = p[:, -1, 1].clone()
    out.add_(bias)
    if relu:
        out.relu_()
    out = out.view(rows, n * s, c)
    if skip is not None:
        out.add_(skip)
    if round_out:
        out = out.bfloat16().float()
    return out, new


def overlap_add(p: torch.Tensor, carry: torch.Tensor, bias: torch.Tensor, relu: bool,
                skip: Optional[torch.Tensor] = None,
                round_out: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``overlap_add_ref``'s function: the kernel for CUDA tensors (or
    raise), the plain version for CPU tensors. p, carry and bias contiguous;
    skip's channels contiguous, its positions C apart, its rows any stride
    apart (a slice of a skip buffer)."""
    global launches
    if p.device.type == "cpu":
        return overlap_add_ref(p, carry, bias, relu, skip, round_out)
    rows, n, two, s, c = p.shape
    if two != 2 or s != STRIDE:
        raise ValueError("overlap_add: p [rows, n, 2, %d, C] expected, got %s"
                         % (STRIDE, tuple(p.shape)))
    _build.require_cuda(p, "overlap_add p", torch.float32)
    carry = carry.contiguous()
    _build.require_cuda(carry, "overlap_add carry", torch.float32, (rows, s, c))
    _build.require_cuda(bias, "overlap_add bias", torch.float32, (c,))
    if skip is not None:
        if (skip.device != p.device or skip.dtype != torch.float32
                or tuple(skip.shape) != (rows, n * s, c) or skip.stride()[1:] != (c, 1)):
            raise ValueError("overlap_add skip: [%d, %d, %d] float32 on %s with positions %d "
                             "floats apart expected, got %s %s of stride %s"
                             % (rows, n * s, c, p.device, c, tuple(skip.shape), skip.dtype,
                                skip.stride()))
    out = torch.empty((rows, n * s, c), device=p.device)
    new = torch.empty((rows, s, c), device=p.device)
    if rows == 0:
        return out, new
    status = _build.library().koala_overlap_add(
        p.data_ptr(), carry.data_ptr(), bias.data_ptr(),
        skip.data_ptr() if skip is not None else None, out.data_ptr(), new.data_ptr(), rows, n,
        c, skip.stride(0) if skip is not None else 0, int(relu), int(round_out),
        _build.stream_handle(p.device))
    launches += 1
    _build.check(status, "koala_overlap_add")
    return out, new


def bound(rows: int, n: int, c: int, skip: bool):
    """Least time (ms) of one pass on an H100 (``profiling.bound``): p read,
    the carry read and written, the skip (where there is one) read and out
    written once; two to four f32 operations an output element."""
    floats = rows * n * 8 * c + 2 * rows * STRIDE * c + rows * STRIDE * n * c * (2 if skip else 1)
    return profiling.bound(floats * 4, 0, 4 * rows * STRIDE * n * c)


__all__ = ["overlap_add", "overlap_add_ref", "bound", "launches"]
