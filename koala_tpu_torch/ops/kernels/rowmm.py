"""Fixed-order float32 product: CUDA kernels and their plain version.

``rowmm(a, b)`` is ``a @ b`` for a [..., K] and b [K, N], float32, with one
promise that a library GEMM does not make: a row of the result has the same
bits whatever the number of rows, and wherever the row lies in the kernel's
tiles. So a stream's frame gives the same spectrum, features and mask in a
call of one frame, of 32 or of 365, and a stream's output does not depend on
how it is cut into calls.

It replaces no TPU kernel: in the JAX package these products are ``jnp``
matmuls outside any Pallas kernel. On the card (csrc/rowmm.cu) every element
is summed in one thread with ``fmaf`` over k in ascending order, in true
float32 (no TF32, no tensor cores, no split-K). Any kernel that keeps that
chain gives the same bits, so the card has four kernels, picked by ``plan``
from the shape alone: a narrow kernel for the fewest rows (the step, live
rounds), a row kernel for some hundreds, a column kernel for N = 1 (the
gate) and a pipelined tile for many rows (process_chunk); and
``rowmm_simple``, the first design, which the card tests and chip_smoke.py
hold them to bit for bit. The
plain version is ``torch.matmul`` over fixed blocks of rows, taken only for
CPU tensors: it keeps the same promise on the CPU, in the library's own
order of sums.

``matmul(a, b)`` is the route of the port's frame-local products (the STFT
and iSTFT bases, the band and cepstral pools, the encoder, decoder, gate and
the scan branch's GRU projections): ``rowmm`` wherever autograd records no
graph, ``torch.matmul`` where it records one (the training path, whose
gradients go through autograd and whose numbers stay as they were). Every
public entry point runs under ``torch.inference_mode()``.

``fused(a, b, bias, ...)`` is the fused entry, for Demucs's bf16 products:
the same product, then its epilogue (bias, ReLU, GLU over paired columns,
a bf16 round of the result, written where the caller's rows lie), with A
rounded to bf16 as it is loaded where asked. CUDA tensors launch the kernel
that ``fused_plan`` picks at any row count (``rowmm_fused_narrow_kernel``
up to ROW_MAX rows, ``rowmm_fused_kernel``'s tile above); CPU tensors run
``fused_ref``, the plain rowmm and the PyTorch ops the epilogue stands for,
which give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ... import profiling
from . import _build

# launches of the kernels of ``rowmm`` (any variant) since the last reset
launches = 0
# launches of ``rowmm_simple``, which no path of the port takes
simple_launches = 0
# launches of the fused entry's kernel (``fused``), also counted in ``launches``
fused_launches = 0

# rows of the plain version's blocks
REF_ROWS = 16

# (name, rows, columns, threads) of a block of each variant, by the number
# that csrc/rowmm.cu's VARIANTS table gives it (koala_rowmm_variant reports
# that table on the card)
VARIANTS = (
    ("narrow<4,128,4>", 4, 8, 128),
    ("narrow<16,64,6>", 16, 8, 128),
    ("row<4,4>", 16, 32, 128),
    ("col", 64, 1, 64),
    ("tile<128,64>", 128, 64, 128),
    ("tile<128,32>", 128, 32, 128),
    ("tile<64,64>", 64, 64, 128),
)
COL = 3
# the fused entry's kernels, by the number that csrc/rowmm.cu's
# koala_rowmm_fused gives each: the narrow kernel's block of 4 or 16 rows and
# 8 output columns, the tile's of 128 rows and 64 product columns
FUSED_VARIANTS = ("fused narrow<4,128,4>", "fused narrow<16,64,5>", "fused tile<128,64>")
# a GLU's value and gate columns interleave in blocks of this many (half the
# fused tile's 64 columns a block: a thread sums a value and its gate)
GLU_BLOCK = 32
# the most rows that a one-row kernel (narrow, row) takes; above it a tile does
ROW_MAX = 1024
# CUDA's limit on a grid's second dimension (the first takes 2**31 - 1)
GRID_Y_MAX = 65535


class Plan(NamedTuple):
    variant: int          # index into VARIANTS (csrc/rowmm.cu's table)
    name: str
    grid: Tuple[int, int]   # (blocks over rows, blocks over columns)
    threads: int


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int) -> Plan:
    """The kernel, block and grid of an [m, k] @ [k, n] product, from the
    shape alone (never the data or the pointers: the server's captured step
    graph replays what it planned). Every variant gives the same bits, so
    the choice moves only the time (scripts/rowmm_variants_torch.py times
    them all on a card):

    - up to 4 rows (the step): narrow<4,128,4>, 8 columns a block, 128 k a
      chunk;
    - up to 64 rows (live rounds), and N = 1 up to 8192: narrow<16,64,6>;
    - N = 1 beyond: col, a thread a row;
    - up to ROW_MAX = 1024 rows: row<4,4>, 32 columns and 16 rows a block;
    - above it a tile: 64 x 64 up to 4096 rows (8192 for N <= 32), then
      128 x 32 for N <= 32 and 128 x 64 for the rest."""
    del k     # every variant takes any K: the choice does not depend on it
    if m <= 4:
        v = 0
    elif m <= 64 or (n == 1 and m <= 8192):
        v = 1
    elif n == 1:
        v = COL
    elif m <= ROW_MAX:
        v = 2
    elif m <= 4096 or (n <= 32 and m <= 8192):
        v = 6
    else:
        v = 5 if n <= 32 else 4
    name, rows, cols, threads = VARIANTS[v]
    return Plan(v, name, (-(-m // rows), -(-n // cols)), threads)


def plan_for(variant: int, m: int, n: int) -> Plan:
    """The plan of ``variant`` at [m, *] @ [*, n], whatever ``plan`` picks
    (to time or hold every variant at one shape)."""
    if variant == COL and n != 1:
        raise ValueError("rowmm: the column kernel takes N = 1, not %d" % n)
    name, rows, cols, threads = VARIANTS[variant]
    return Plan(variant, name, (-(-m // rows), -(-n // cols)), threads)


def row_layout(a: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(inner, s_outer, s_inner) such that row r of a's rows (a [..., K]
    flattened to [M, K]) starts (r // inner) * s_outer + (r % inner) *
    s_inner elements past a's first, or None where a's rows are not laid out
    so (its last axis not contiguous, or three or more row axes that do not
    merge). A contiguous tensor is (M, 0, K); a permuted view [B, T, K] of a
    [T, B, K] tensor (T, K, B K): the kernels read it without a copy."""
    k = a.shape[-1]
    if k > 1 and a.stride(-1) != 1:
        return None
    axes = []
    for size, stride in zip(a.shape[:-1], a.stride()[:-1]):
        if size == 1:
            continue
        if axes and axes[-1][1] == stride * size:
            axes[-1] = (axes[-1][0] * size, stride)
        else:
            axes.append((size, stride))
    if not axes:
        return 1, 0, k
    if len(axes) == 1:
        return axes[0][0], 0, axes[0][1]
    if len(axes) == 2:
        return axes[1][0], axes[0][1], axes[1][1]
    return None


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


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if b.dim() != 2 or a.dim() < 1 or a.shape[-1] != b.shape[0]:
        raise ValueError("rowmm: a [..., K] and b [K, N] expected, got %s and %s"
                         % (tuple(a.shape), tuple(b.shape)))
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("rowmm: float32 operands expected, got %s and %s" % (a.dtype, b.dtype))
    if a.device != b.device:
        raise ValueError("rowmm: a on %s, b on %s" % (a.device, b.device))


def _check_cuda(a: torch.Tensor, b: torch.Tensor) -> int:
    """Validate operands for a launch; return the row count M."""
    if a.device.type != "cuda":
        raise ValueError("rowmm a: expected a CUDA tensor, got %s" % a.device)
    _build.require_cuda(b, "rowmm b", torch.float32)
    for name, t in (("a", a), ("b", b)):
        # the kernels copy 16-byte-aligned spans around a row: they may begin
        # up to 12 bytes before the tensor, never before its storage
        if t.data_ptr() % 4 or t.untyped_storage().data_ptr() % 16:
            raise ValueError("rowmm %s: expected a 4-byte aligned tensor in 16-byte aligned "
                             "storage" % name)
    m = math.prod(a.shape[:-1])
    k, n = b.shape
    if max(m, n, k) >= 2 ** 31:
        raise ValueError("rowmm: [%d, %d] @ [%d, %d] is too large for one launch" % (m, k, k, n))
    return m


def launch(a: torch.Tensor, b: torch.Tensor, p: Plan) -> torch.Tensor:
    """a [..., K] @ b [K, N] on the card by plan ``p`` (``rowmm`` passes
    ``plan(M, N, K)``; the card tests and chip_smoke.py pass every variant).
    a's rows may lie as ``row_layout`` says; b is contiguous. Raises on what
    it does not take or on a launch the card refused."""
    _check(a, b)
    return _launch(a, b, p)


def _launch(a: torch.Tensor, b: torch.Tensor, p: Plan) -> torch.Tensor:
    global launches
    m = _check_cuda(a, b)
    k, n = b.shape
    layout = (m, 0, k) if a.is_contiguous() else row_layout(a)
    if layout is None:
        raise ValueError("rowmm a: rows of stride %s are not taken (the last axis must be "
                         "contiguous, the rows at most two strides)" % (a.stride(),))
    c = torch.empty(a.shape[:-1] + (n,), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return c
    inner, s_outer, s_inner = layout
    # floats from A's first element past its last (the kernels' copies stop there)
    extent = ((m - 1) // inner) * s_outer + (min(inner, m) - 1) * s_inner + k
    if extent >= 2 ** 31:
        raise ValueError("rowmm a: %d floats from its first element to its last: too many for "
                         "one launch" % extent)
    if p.grid[1] > GRID_Y_MAX:
        raise ValueError("rowmm: N = %d needs %d column blocks, more than a grid takes"
                         % (n, p.grid[1]))
    status = _build.library().koala_rowmm(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, inner, s_outer, s_inner, extent,
        p.variant, p.grid[0], p.grid[1], _build.stream_handle(a.device))
    launches += 1
    _build.check(status, "koala_rowmm (%s)" % p.name)
    return c


def rowmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., K] f32 @ b [K, N] f32 -> [..., N] f32 (contiguous), every row
    summed in the same fixed order. CPU tensors take the plain version; CUDA
    tensors launch the kernel that ``plan`` picks (or raise). a's rows may
    be a permuted view (``row_layout``); b must be contiguous."""
    _check(a, b)
    if a.device.type == "cpu":
        return rowmm_ref(a, b)
    k, n = b.shape
    return _launch(a, b, plan(math.prod(a.shape[:-1]), n, k))


def rowmm_simple(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The first design's kernel (csrc/rowmm.cu ``rowmm_simple_kernel``),
    a [..., K] @ b [K, N], both contiguous, on the card only. No path of the
    port takes it: it is the yardstick that the other kernels' bits are
    held to (no plain PyTorch function reproduces an fmaf chain)."""
    global simple_launches
    _check(a, b)
    _build.require_cuda(a, "rowmm_simple a", torch.float32)
    m = _check_cuda(a, b)
    k, n = b.shape
    c = torch.empty(a.shape[:-1] + (n,), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return c
    status = _build.library().koala_rowmm_simple(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                                 m, n, k, _build.stream_handle(a.device))
    simple_launches += 1
    _build.check(status, "koala_rowmm_simple")
    return c


def _round(t: torch.Tensor) -> torch.Tensor:
    """The bf16 rounding of an operand, held as f32."""
    return t.bfloat16().float()


def _glu_pairs(n: int) -> int:
    """The number of GLU_BLOCK blocks of a GLU over n product columns."""
    if n % (2 * GLU_BLOCK):
        raise ValueError("rowmm: a GLU pairs its value and gate columns in blocks of %d: "
                         "N = %d is no multiple of %d" % (GLU_BLOCK, n, 2 * GLU_BLOCK))
    return n // (2 * GLU_BLOCK)


def pair_glu(w: torch.Tensor) -> torch.Tensor:
    """A GLU's product columns [..., 2C] ([value | gate], as ``nn.GLU`` splits
    them; C a multiple of GLU_BLOCK) in the fused entry's order: blocks of
    GLU_BLOCK value columns, each followed by their gates' columns."""
    c, blocks = w.shape[-1] // 2, _glu_pairs(w.shape[-1])
    return torch.stack([w[..., :c].unflatten(-1, (blocks, GLU_BLOCK)),
                        w[..., c:].unflatten(-1, (blocks, GLU_BLOCK))], dim=-2).flatten(-3)


def unpair_glu(w: torch.Tensor) -> torch.Tensor:
    """``pair_glu``'s inverse: [value | gate]."""
    pairs = w.unflatten(-1, (_glu_pairs(w.shape[-1]), 2, GLU_BLOCK))
    return torch.cat([pairs[..., 0, :].flatten(-2), pairs[..., 1, :].flatten(-2)], dim=-1)


def fused_plan(m: int) -> int:
    """The fused entry's variant (FUSED_VARIANTS) for m rows, from the row
    count alone, as ``plan``: the narrow kernel's block of 4 rows up to 4,
    of 16 up to ROW_MAX, the tile above."""
    return 0 if m <= 4 else 1 if m <= ROW_MAX else 2


def fused_ref(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, out: torch.Tensor,
              relu: bool, glu: bool, round_a: bool, round_out: bool) -> torch.Tensor:
    """Plain version of ``fused``: the product through ``matmul`` (the
    kernel ``plan`` picks on a card, ``rowmm_ref`` on the CPU), then the
    PyTorch ops the kernel's epilogue stands for, into ``out``."""
    z = matmul(_round(a) if round_a else a, b)
    z.add_(bias)
    if relu:
        z.relu_()
    if glu:
        pairs = z.unflatten(-1, (_glu_pairs(z.shape[-1]), 2, GLU_BLOCK))
        z = torch.mul(pairs[..., 0, :], pairs[..., 1, :].sigmoid_()).flatten(-2)
    out.copy_(_round(z) if round_out else z)
    return out


def launch_fused(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, out: torch.Tensor,
                 relu: bool = False, glu: bool = False, round_a: bool = False,
                 round_out: bool = False, variant: Optional[int] = None) -> torch.Tensor:
    """``fused`` on the card by FUSED_VARIANTS[variant] (``fused`` passes
    ``fused_plan``'s; the card tests pass every variant at any row count).
    out's rows may lie as ``row_layout`` says, its columns contiguous."""
    global launches, fused_launches
    _check(a, b)
    m = _check_cuda(a, b)
    k, n = b.shape
    if glu:
        _glu_pairs(n)
    _build.require_cuda(bias, "rowmm bias", torch.float32, (n,))
    layout = (m, 0, k) if a.is_contiguous() else row_layout(a)
    out_layout = row_layout(out)
    if layout is None or out_layout is None or out.dtype != torch.float32:
        raise ValueError("rowmm fused: a's rows %s or out's %s are not taken"
                         % (a.stride(), out.stride()))
    if out.device != a.device or tuple(out.shape) != tuple(a.shape[:-1]) + (n // 2 if glu else n,):
        raise ValueError("rowmm fused: out %s on %s for a %s, n %d%s"
                         % (tuple(out.shape), out.device, tuple(a.shape), n,
                            ", glu" if glu else ""))
    if m == 0:
        return out
    inner, s_outer, s_inner = layout
    extent = ((m - 1) // inner) * s_outer + (min(inner, m) - 1) * s_inner + k
    if extent >= 2 ** 31:
        raise ValueError("rowmm a: %d floats from its first element to its last: too many for "
                         "one launch" % extent)
    status = _build.library().koala_rowmm_fused(
        a.data_ptr(), b.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, k, inner, s_outer,
        s_inner, extent, *out_layout, fused_plan(m) if variant is None else variant,
        int(round_a), int(glu), int(relu), int(round_out), _build.stream_handle(a.device))
    launches += 1
    fused_launches += 1
    _build.check(status, "koala_rowmm_fused")
    return out


def fused(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor, *, relu: bool = False,
          glu: bool = False, round_a: bool = False, round_out: bool = False,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused entry: a [..., K] @ b [K, N] (every element the fixed
    chain of ``rowmm``; with round_a, a's elements rounded to bf16 first),
    then per element + bias [N], ReLU (relu), GLU (glu: b's and bias's
    columns in ``pair_glu``'s order, N / 2 outputs) and a bf16 round
    (round_out), into out ([..., N or N / 2], whose rows may be a slice of
    a larger buffer; a new tensor where None). CPU tensors take the plain
    version, ``fused_ref``; CUDA tensors launch the kernel that
    ``fused_plan`` picks (or raise): the same bits."""
    _check(a, b)
    k, n = b.shape
    if out is None:
        out = torch.empty(a.shape[:-1] + (n // 2 if glu else n,), device=a.device)
    if a.device.type == "cpu":
        return fused_ref(a, b, bias, out, relu, glu, round_a, round_out)
    return launch_fused(a, b, bias, out, relu, glu, round_a, round_out)


def variants_on_card():
    """The card's VARIANTS table (csrc/rowmm.cu, through
    ``koala_rowmm_variant``): (rows, columns, threads) of each variant."""
    out = (ctypes.c_int * 3)()
    table = []
    for v in range(len(VARIANTS)):
        _build.check(_build.library().koala_rowmm_variant(v, out), "koala_rowmm_variant")
        table.append(tuple(out))
    return table


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The frame-local product: ``torch.matmul`` where autograd records a
    graph of it (training), else ``rowmm`` (its plain version on the CPU).
    a goes as it lies where ``row_layout`` takes it (the decoder's and the
    gate's input, a permuted view of the GRU's output), else as a copy."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return torch.matmul(a, b)
    if not a.is_contiguous() and row_layout(a) is None:
        a = a.contiguous()
    return rowmm(a, b.contiguous())


def bound(m: int, k: int, n: int):
    """Least time (ms) of a [m, k] @ [k, n] f32 product on an H100
    (``profiling.bound``): both operands read and the result written once;
    m n k FMAs (2 m n k operations) on the CUDA cores."""
    return profiling.bound((m * k + k * n + m * n) * 4, 0, 2 * m * n * k)


def chain_ms(k: int, clock_mhz: float, fma_cycles: int = 4) -> float:
    """The time of one element's chain of k dependent FMAs at ``clock_mhz``
    (about 4 cycles an FMA on Hopper): the floor of a product's time at one
    row, however many threads it has."""
    return k * fma_cycles / (clock_mhz * 1e3)


__all__ = ["rowmm", "rowmm_ref", "rowmm_simple", "launch", "plan", "plan_for", "row_layout",
           "matmul", "fused", "fused_ref", "launch_fused", "fused_plan", "pair_glu",
           "unpair_glu", "bound", "chain_ms", "variants_on_card", "VARIANTS",
           "FUSED_VARIANTS", "GLU_BLOCK", "ROW_MAX"]
