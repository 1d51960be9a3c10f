"""One LSTM layer-step over many rows: CUDA kernel and its plain version.

``lstm_cell(x, h, c, w, b)`` computes, for every row,

    gates = [bf16(x) | 0 | bf16(h)] @ W + b      (bf16 operands, f32 sums)
    i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four H-wide blocks
    c' = f c + i g;   h' = o tanh(c')             (f32)

with ``b`` [4H] = b_ih + b_hh in f32 and ``w`` [4H, kxp + H] bf16, W's
transpose in pass order: its columns 0..kx-1 are W_ih, then zeros up to kxp
(kx rounded up to 16), then W_hh, and its row 32 g + 8 q + t holds gate q
(i, f, g, o) of hidden unit 8 g + t. ``stack_weights`` builds it from
PyTorch's [4H, in] layout; ``unstack`` gives PyTorch's gate order back.

It replaces no TPU kernel: the JAX package has no LSTM. It serves
FullSubNet's two recurrences (models/fullsubnet.py): the sub-band LSTM on
B x 257 rows and the full-band LSTM on B rows; and Demucs's bottleneck LSTM
(models/demucs.py) on B rows at kx = H = 1024. On the card (csrc/lstm.cu)
one launch is the product and the cell, a warp-specialised persistent
kernel in clusters of two blocks:

- the tile: ``tile_rows(kx, H)`` rows of [x | 0 | h] as bf16 in shared
  memory, the whole depth, one consumer warpgroup a 64 rows issuing wgmma
  (m64n128k16) on it; a pass is 128 gate columns, the four gates of 32
  hidden units (the pass order above), so the epilogue finishes c' and h'
  in registers and the gates never reach device memory;
- the ring: a producer warp a block streams W by TMA through stages of 32
  deep x 128 columns; each block of a cluster fetches half of every stage
  and multicasts it into both, so a byte of W from L2 serves both blocks'
  tiles and each block's TMA unit moves half of what it multiplies;
- the persistent walk: as many clusters as are resident walk the work
  items (pair of row tiles, group of passes), the producers running ahead
  across them.

The tile height follows the width alone, never the row count: 128 rows
where the A tile and a ring of four stages fit in a block's 227 KB (the
sub-band's K = 416 and 768), else 64 (the full band's 784 and 1024). Where
even 64 rows of the whole depth do not fit (Demucs's LSTM, kx = H = 1024,
models/demucs.py), the tile holds K-panels (``tile_depth``: 1024 of 2048)
and each pass reloads the segments it walks, an odd pass the last segment
first. A row's sums run over k in one order, the pass's own, at any place
in any tile, so a stream's bits do not depend on its batch. ``plan`` splits the passes into groups
from the shape, so few rows still fill the card. At 526,336 rows the ring's
delivery of W into each block bounds the kernel first, then each tile's A
load and the gates' special functions, neither hidden behind the products.
The plain version (CPU tensors only) takes the product as ``rowmm_ref``
does, over fixed blocks of rows, so on the CPU too a row's bits depend on
that row alone.

x, h and c may be row-strided views (the last axis contiguous): the state
[*, 257, L, H] hands over one layer's rows as they lie. h' and c' go into
``h_out`` and ``c_out`` where given (views of a new state), else new
tensors. Every public entry point runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import profiling
from . import _build
from .gru import H100_SMS
from .rowmm import rowmm_ref

# launches of the CUDA kernel since the last reset
launches = 0

UNITS = 32          # hidden units of one pass of the kernel (128 gate columns)
CLUSTER = 2         # blocks of a cluster, which share the weights' stages
SMEM_BYTES = 232448     # shared memory a block may hold on an H100
SMEM_SLACK = 1024 + 256  # the kernel's alignment of its carve-out, its barriers
STAGE_BYTES = 8192      # a stage of the weight ring: 32 deep x 128 gate columns, bf16
RING_128 = 4            # stages a 128-row tile needs beside it
RING_64 = 2


def padded(kx: int) -> int:
    """Columns of x in the kernel's operand: kx rounded up to 16."""
    return -(-kx // 16) * 16


def _pass_order(h: int):
    """Row r of the kernel's w -> row of PyTorch's [4H, *] (gate blocks i, f,
    g, o): r = 32 g + 8 q + t is gate q of unit 8 g + t."""
    return torch.arange(4 * h).view(4, h // 8, 8).permute(1, 0, 2).reshape(-1)


def stack_weights(w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor,
                  b_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch's LSTM layer ([4H, in], [4H, H], [4H], [4H]; gates i, f, g,
    o) -> the kernel's (w [4H, padded(in) + H] bf16 in pass order, b [4H]
    f32 in PyTorch's order)."""
    four_h, kx = w_ih.shape
    h = w_hh.shape[1]
    if h % 8:
        raise ValueError("stack_weights: H = %d is not a multiple of 8" % h)
    w = torch.zeros((four_h, padded(kx) + h), dtype=torch.bfloat16, device=w_ih.device)
    w[:, :kx] = w_ih.bfloat16()
    w[:, padded(kx):] = w_hh.bfloat16()
    return (w[_pass_order(h).to(w.device)].contiguous(),
            (b_ih.float() + b_hh.float()).contiguous())


def unstack(w: torch.Tensor) -> torch.Tensor:
    """The kernel's w [4H, K] in pass order -> [K, 4H] in PyTorch's gate
    order (the product's right operand)."""
    out = torch.empty_like(w)
    out[_pass_order(w.shape[0] // 4).to(w.device)] = w
    return out.t()


def _fits(rows: int, depth: int, ring: int) -> bool:
    """Whether an A tile of ``rows`` x ``depth`` (bf16, in 64-deep panels of
    128-byte rows) and a ring of ``ring`` stages fit in a block."""
    return SMEM_SLACK + rows * -(-depth // 64) * 128 + ring * STAGE_BYTES <= SMEM_BYTES


def tile_rows(kx: int, h: int) -> int:
    """Rows of the kernel's tile at a width: 128 where the whole depth and a
    ring of RING_128 stages fit in a block's shared memory, else 64 (in
    K-panels, ``tile_depth``, where even 64 rows of the whole depth do not
    fit). From (kx, H) alone, never the row count."""
    return 128 if _fits(128, padded(kx) + h, RING_128) else 64


def tile_depth(kx: int, h: int) -> int:
    """Depth the A tile holds at a width: the whole depth kxp + H where it
    fits beside a ring (RING_128 stages at 128 rows, RING_64 at 64), else the
    K-panel: the depth cut into the fewest equal segments, each a multiple
    of 64, of which 64 rows fit beside a ring of RING_128 stages (1024 of
    2048 at Demucs's kx 1024, H 1024). Each pass then walks the segments,
    reloading each, in the undivided tile's order of sums."""
    k = padded(kx) + h
    rows = tile_rows(kx, h)
    if _fits(rows, k, RING_128 if rows == 128 else RING_64):
        return k
    n = 2
    while not _fits(64, -(-k // (64 * n)) * 64, RING_128):
        n += 1
    return -(-k // (64 * n)) * 64


def plan(m: int, kx: int, h: int) -> Tuple[int, int, int]:
    """(tile rows, passes a block, pass groups) of a launch over m rows at
    (kx, H): the tile height from the width alone; the passes split over as
    many groups as it takes for the work items (pair of row tiles, group of
    passes) to reach one a cluster of two blocks on an H100. In K-panels,
    where every pass reloads its rows, as many as fit the clusters in one
    round: a second round for a few items would cost each of its passes
    again."""
    rows = tile_rows(kx, h)
    pairs = -(-(-(-m // rows)) // CLUSTER)
    passes = -(-h // UNITS)
    clusters = H100_SMS // CLUSTER
    if tile_depth(kx, h) < padded(kx) + h:
        split = min(passes, max(1, clusters // pairs))
    else:
        split = min(passes, max(1, -(-clusters // pairs)))
    per_block = -(-passes // split)
    return rows, per_block, -(-passes // per_block)


def _check(x, h, c, w, b) -> Tuple[int, int, int]:
    if x.dim() != 2 or h.dim() != 2 or c.shape != h.shape or x.shape[0] != h.shape[0]:
        raise ValueError("lstm_cell: x [M, kx], h and c [M, H] expected, got %s, %s, %s"
                         % (tuple(x.shape), tuple(h.shape), tuple(c.shape)))
    m, kx = x.shape
    hid = h.shape[1]
    if hid % 16:
        raise ValueError("lstm_cell: H = %d is not a multiple of 16" % hid)
    if tuple(w.shape) != (4 * hid, padded(kx) + hid) or tuple(b.shape) != (4 * hid,):
        raise ValueError("lstm_cell: w [%d, %d] and b [%d] expected, got %s and %s"
                         % (4 * hid, padded(kx) + hid, 4 * hid, tuple(w.shape), tuple(b.shape)))
    for name, t in (("x", x), ("h", h), ("c", c)):
        if t.dtype != torch.float32 or (t.shape[1] > 1 and t.stride(1) != 1):
            raise ValueError("lstm_cell %s: float32 rows with a contiguous last axis expected"
                             % name)
    return m, kx, hid


def lstm_cell_ref(x, h, c, w, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the product as ``rowmm_ref`` (fixed blocks of rows) on
    the bf16-rounded operands, the gates in f32. -> (h', c') [M, H]."""
    m, kx, hid = _check(x, h, c, w, b)
    a = torch.cat([x.bfloat16().float(), x.new_zeros((m, padded(kx) - kx)),
                   h.bfloat16().float()], dim=-1)
    gates = rowmm_ref(a, unstack(w).float()) + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _launch(x, h, c, w, b, h_out, c_out) -> None:
    global launches
    m, kx, hid = _check(x, h, c, w, b)
    _build.require_cuda(w, "lstm_cell w", torch.bfloat16, aligned=True)
    _build.require_cuda(b, "lstm_cell b", torch.float32)
    for name, t in (("x", x), ("h", h), ("c", c), ("h_out", h_out), ("c_out", c_out)):
        if t.device != w.device:
            raise ValueError("lstm_cell %s: on %s, w on %s" % (name, t.device, w.device))
    # c is read and h', c' written two floats at a time
    for name, t in (("c", c), ("h_out", h_out), ("c_out", c_out)):
        if tuple(t.shape) != (m, hid) or (m > 1 and t.stride(0) % 2) or t.data_ptr() % 8:
            raise ValueError("lstm_cell %s: [%d, %d] rows starting 8-byte aligned expected"
                             % (name, m, hid))
    if m == 0:
        return
    rows, per_block, groups = plan(m, kx, hid)
    if -(-m // rows) * groups >= 2 ** 31:
        raise ValueError("lstm_cell: %d rows are too many for one launch" % m)
    depth = tile_depth(kx, hid)
    status = _build.library().koala_lstm_cell(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        w.data_ptr(), b.data_ptr(), x.stride(0), h.stride(0), c.stride(0), h_out.stride(0),
        c_out.stride(0), m, kx, padded(kx), hid, rows, per_block, groups,
        -(-depth // 64) * 64, _build.stream_handle(w.device))
    launches += 1
    _build.check(status, "koala_lstm_cell")


@torch.inference_mode()
def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor, h_out: Optional[torch.Tensor] = None,
              c_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, kx], h and c [M, H] f32 (row-strided views allowed) ->
    (h', c') [M, H] f32, written into ``h_out`` / ``c_out`` when given (they
    must not overlap x, h or c). CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if h_out is None:
        h_out = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    if c_out is None:
        c_out = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    if x.device.type == "cpu":
        h_new, c_new = lstm_cell_ref(x, h, c, w, b)
        h_out.copy_(h_new)
        c_out.copy_(c_new)
    else:
        _launch(x, h, c, w, b, h_out, c_out)
    return h_out, c_out


def bound(m: int, kx: int, h: int):
    """Least time (ms) of one layer-step over m rows on an H100
    (``profiling.bound``): x, h and c read and h', c' written in f32, the
    weights (bf16) and bias once; 2 m (kx + H) 4H bf16 operations on the
    tensor cores beside the cell's f32 math (four gate functions, two
    products and an add, a tanh: about 40 operations a unit). The same at
    every depth, K-panels included: their reloads of the rows come from L2
    and are the design's cost, not the work's."""
    n_bytes = (m * kx + 4 * m * h) * 4 + (padded(kx) + h) * 4 * h * 2 + 4 * h * 4
    mm = 2 * m * (kx + h) * 4 * h
    ew = 40 * m * h
    return profiling.bound(n_bytes, mm, ew)


__all__ = ["lstm_cell", "lstm_cell_ref", "stack_weights", "unstack", "plan", "tile_rows",
           "tile_depth", "padded", "bound"]
