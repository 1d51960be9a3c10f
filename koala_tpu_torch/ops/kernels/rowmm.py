"""Fixed-order float32 product: CUDA kernel and its plain version.

``rowmm(a, b)`` is ``a @ b`` for a [..., K] and b [K, N], float32, with one
promise that a library GEMM does not make: a row of the result has the same
bits whatever the number of rows, and wherever the row lies in the kernel's
tiles. So a stream's frame gives the same spectrum, features and mask in a
call of one frame, of 32 or of 365, and a stream's output does not depend on
how it is cut into calls.

It replaces no TPU kernel: in the JAX package these products are ``jnp``
matmuls outside any Pallas kernel. On the card the kernel (csrc/rowmm.cu)
sums each element in one thread with ``fmaf`` over k in ascending order, in
true float32 (no TF32, no tensor cores); its bound is operations, the f32
FMAs on the CUDA cores. The plain version is ``torch.matmul`` over fixed
blocks of rows, taken only for CPU tensors: it keeps the same promise on
the CPU, in the library's own order of sums.

``matmul(a, b)`` is the route of the port's frame-local products (the STFT
and iSTFT bases, the band and cepstral pools, the encoder, decoder, gate and
the scan branch's GRU projections): ``rowmm`` wherever autograd records no
graph, ``torch.matmul`` where it records one (the training path, whose
gradients go through autograd and whose numbers stay as they were). Every
public entry point runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import math

import torch

from ... import profiling
from . import _build

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0


# rows of the plain version's blocks
REF_ROWS = 16


def rowmm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a [..., K] @ b [K, N] -> [..., N], as ``torch.matmul``
    over blocks of REF_ROWS rows (the last padded with zero rows) against b
    of at least two columns. A library GEMM takes other paths for one row,
    one column or another row count, and sums in another order there; every
    block of one shape takes the same path, so on the CPU too a row's bits
    depend only on that row and on b."""
    k, n = b.shape
    lead = a.shape[:-1]
    a2 = a.reshape(-1, k)
    m = a2.shape[0]
    pad = -m % REF_ROWS
    if pad:
        a2 = torch.cat([a2, a2.new_zeros((pad, k))])
    b2 = torch.cat([b, torch.zeros_like(b)], dim=1) if n == 1 else b
    out = torch.cat([torch.matmul(a2[i:i + REF_ROWS], b2)
                     for i in range(0, m + pad, REF_ROWS)]) if m else a2.new_zeros((0, n))
    return out[:m, :n].reshape(lead + (n,))


def rowmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] f32 @ b [K, N] f32 -> [..., N] f32, every row summed in the
    same fixed order. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    global launches
    if b.dim() != 2 or a.dim() < 1 or a.shape[-1] != b.shape[0]:
        raise ValueError("rowmm: a [..., K] and b [K, N] expected, got %s and %s"
                         % (tuple(a.shape), tuple(b.shape)))
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("rowmm: float32 operands expected, got %s and %s" % (a.dtype, b.dtype))
    if a.device != b.device:
        raise ValueError("rowmm: a on %s, b on %s" % (a.device, b.device))
    if a.device.type == "cpu":
        return rowmm_ref(a, b)
    k, n = b.shape
    _build.require_cuda(a, "rowmm a", torch.float32)
    _build.require_cuda(b, "rowmm b", torch.float32)
    for name, t in (("a", a), ("b", b)):
        if t.data_ptr() % 4:
            raise ValueError("rowmm %s: expected a 4-byte aligned tensor" % name)
    m = math.prod(a.shape[:-1])
    if max(m, n, k) >= 2 ** 31:
        raise ValueError("rowmm: [%d, %d] @ [%d, %d] is too large for one launch" % (m, k, k, n))
    c = torch.empty(a.shape[:-1] + (n,), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return c
    status = _build.library().koala_rowmm(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                                          _build.stream_handle(a.device))
    launches += 1
    _build.check(status, "koala_rowmm")
    return c


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The frame-local product: ``torch.matmul`` where autograd records a
    graph of it (training), else ``rowmm`` (its plain version on the CPU)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return torch.matmul(a, b)
    return rowmm(a.contiguous(), b.contiguous())


def bound(m: int, k: int, n: int):
    """Least time (ms) of a [m, k] @ [k, n] f32 product on an H100
    (``profiling.bound``): both operands read and the result written once;
    m n k FMAs (2 m n k operations) on the CUDA cores."""
    return profiling.bound((m * k + k * n + m * n) * 4, 0, 2 * m * n * k)


__all__ = ["rowmm", "rowmm_ref", "matmul", "bound"]
