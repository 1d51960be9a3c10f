"""Fused GRU-stack recurrence: CUDA kernel, its plain version, its gradient.

``gru_stack`` replaces the JAX package's TPU kernel ``gru_stack_pallas``
(ops/pallas/gru.py:103, kernel body :60) in both of its traced variants.
Per step and layer, with x_0 = x[t] (bf16):

    xp = bf16(x_l) @ wx_l + bx_l,  hp = bf16(h_l) @ wh_l + bh_l   (f32 sums)
    z, r, n gates as _gru_gates (gru.py:50-57), h_l' = (1-z) n + z h_l
    x_{l+1} = x_l + h_l' in f32, re-cast to bf16;  y[t] = x_L

With ``return_hidden`` the kernel also streams the post-update state of
every layer at every step out as ``hs [T, L, B, H]`` f32, the residuals of
the backward pass. ``gru_stack_trainable`` is the differentiable form: the
``return_hidden`` kernel forward, and a reverse-time pass in plain PyTorch
over ``hs`` as backward (the JAX package's backward, gru.py:253-272, is a
plain reverse scan too, not a kernel). The card's training variant writes
``hs`` straight to device memory and needs no more shared memory than the
inference variant, so, unlike the TPU's shape gate, there is no branch that
falls back from the kernel to the scan for training.

On this card the least time is set by the bf16 products (operations), but a
recurrence cannot reach it: its steps depend on each other. The kernel
(csrc/gru.cu) is one cooperative launch of a persistent grid that is
weight-stationary and column-split: a block owns ``slice_width`` hidden
units of every layer and gathers their gate columns of wx and wh once, as
tensor-core fragments in its warps' registers, where they stay for all T.
It holds the f32 state and residual stream of its slice in shared memory,
publishes only bf16 activations to the other blocks through a small exchange
buffer that stays in L2, and meets them at one barrier per tick of a
wavefront over the layers (layer l works on step k - l in tick k: T + L - 1
ticks). Rows are cut into chunks that run side by side as row groups of the
one grid, or one after the other where the card cannot hold them all.
Stacks whose weights one block's warps cannot hold are cut into layer
groups, each on blocks of its own (the f32 residual stream crosses between
them through device memory), and where even that leaves a block more units
than warps, the extra units keep their weights in shared memory.
``plan_launch`` decides all of that from the shapes alone (see the source's
note for the rest).

Weights come stacked: wx, wh [L, H, 3H] bf16 and bx, bh [L, 3H] f32.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ... import profiling
from . import _build

# launches of the CUDA kernel since the last reset (plain integers): the
# inference variant and the return_hidden (training) variant
launches = 0
launches_hs = 0


def _gates(h, hp, xp):
    """_gru_gates in f32: h [B,H], hp/xp [B,3H] -> new h [B,H]."""
    hz, hr, hn = hp.chunk(3, dim=-1)
    xz, xr, xn = xp.chunk(3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def layers_step(h_prev, x_bf, wx, bx, wh, bh):
    """One step through the stack, the kernel's numerics: bf16 product
    inputs, f32 sums, gates and state, bf16 residual stream.
    h_prev [L,B,H] f32, x_bf [B,H] bf16 -> (h_new [L,B,H] f32, y_t [B,H] bf16)."""
    x_f = x_bf.float()
    xb = x_bf
    new_h = []
    for l in range(h_prev.shape[0]):
        xp = xb.float() @ wx[l].float() + bx[l]
        hp = h_prev[l].bfloat16().float() @ wh[l].float() + bh[l]
        h_new = _gates(h_prev[l], hp, xp)
        new_h.append(h_new)
        x_f = x_f + h_new
        xb = x_f.bfloat16()
    return torch.stack(new_h), xb


def gru_stack_ref(h0, x, wx, bx, wh, bh, return_hidden: bool = False):
    """Plain version: h0 [L,B,H] f32, x [T,B,H] -> (y [T,B,H] bf16,
    h_final [L,B,H] f32), with ``return_hidden`` (y, hs [T,L,B,H] f32,
    h_final)."""
    h = h0.float()
    wx, wh = wx.bfloat16(), wh.bfloat16()
    ys, hs = [], []
    for t in range(x.shape[0]):
        h, y_t = layers_step(h, x[t].bfloat16(), wx, bx.float(), wh, bh.float())
        ys.append(y_t)
        hs.append(h)
    y = torch.stack(ys) if ys else x.bfloat16()
    if not return_hidden:
        return y, h
    return y, (torch.stack(hs) if hs else h.new_zeros((0,) + tuple(h.shape))), h


# What one H100 offers a block (the plan's defaults; on a card the wrapper
# asks the device for its own SM count).
H100_SMS = 132
H100_SMEM_BYTES = 232448
WARPS = 16                     # csrc/gru.cu GRU_WARPS (512 threads)
UNIT_K_TILES = 12              # k tiles of weights that a warp's registers hold
MAX_CHUNK_ROWS = 64
# Slice widths in the order they are tried: the first whose units fit a
# block's warps and registers and whose 16-row tile fits its shared memory.
# The wider slice halves what the blocks read of each other; on the H100 it
# was the faster one at every shape timed.
SLICE_WIDTHS = (16, 8)
FRAG_TILE_BYTES = 3 * 32 * 8   # csrc/gru.cu FRAG_TILE uint2: one k tile of a unit


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GruPlan:
    """How one ``gru_stack`` launch is laid over the card."""
    slice_width: int        # hidden units of every layer of its group that a block owns
    slices: int             # blocks of a layer group: hidden / slice_width
    layer_groups: int       # groups of consecutive layers, each on its own blocks
    block_layers: int       # layers of a group (the last group may hold fewer)
    chunk_rows: int         # rows of a chunk, a multiple of 16
    chunks: int             # row chunks covering the batch
    groups: int             # row chunks in flight at once, each on its own blocks
    passes: int             # chunks that the busiest group walks through
    blocks: int             # groups * slices * layer_groups, all resident at once
    k_splits: int           # k ranges per product half
    spilled_units: int      # units of a block past its warps (fragments in shared memory)
    smem_bytes: int         # shared memory of one block
    exchange_elems: int     # bf16 elements of the exchange buffer
    layers: int

    @property
    def group_blocks(self) -> int:
        """Blocks of one row group, all of which meet at its barriers."""
        return self.slices * self.layer_groups

    def barriers(self, t_len: int) -> int:
        """Grid barriers that the busiest row group passes in one launch: one
        to publish a chunk's state, one between two of its T + L - 1 ticks."""
        return self.passes * (1 + max(0, t_len + self.layers - 2))

    def chunk_range(self, chunk: int, batch: int):
        """Rows [start, stop) of ``batch`` that ``chunk`` owns."""
        start = chunk * self.chunk_rows
        return start, min(batch, start + self.chunk_rows)

    def slice_range(self, j: int):
        """Hidden units [start, stop) that block ``j`` of a layer group owns."""
        return j * self.slice_width, (j + 1) * self.slice_width

    def layer_range(self, i: int):
        """Layers [start, stop) of layer group ``i``."""
        start = i * self.block_layers
        return start, min(self.layers, start + self.block_layers)

    def group_chunks(self, group: int):
        """The chunks that row group ``group`` walks through, in order."""
        return list(range(group, self.chunks, self.groups))


def k_splits(hidden: int, layers: int, slice_width: int) -> int:
    """csrc/gru.cu gru_k_splits: k ranges per product half of a block of
    ``layers`` layers, short enough for a warp's registers and enough of
    them to give every warp a unit."""
    k_tiles = hidden // 16
    return min(k_tiles, max(_ceil_div(k_tiles, UNIT_K_TILES),
                            WARPS // (layers * (slice_width // 8) * 2)))


def units(hidden: int, layers: int, slice_width: int) -> int:
    """csrc/gru.cu gru_units: (layer, 8-unit tile, half, k range) units of a
    block of ``layers`` layers; warp w runs units w, w + 16, ..."""
    return layers * (slice_width // 8) * 2 * k_splits(hidden, layers, slice_width)


def spilled_units(hidden: int, layers: int, slice_width: int) -> int:
    """csrc/gru.cu gru_spilled_units: units past the warps, whose weights lie
    in shared memory instead of a warp's registers."""
    return max(0, units(hidden, layers, slice_width) - WARPS)


def fits_registers(hidden: int, layers: int, slice_width: int) -> bool:
    """Whether every unit of a block of ``layers`` layers finds a warp of its
    own, its weights in that warp's registers."""
    return spilled_units(hidden, layers, slice_width) == 0


def smem_bytes(hidden: int, layers: int, slice_width: int, chunk_rows: int) -> int:
    """csrc/gru.cu gru_smem_layout of a block of ``layers`` layers: biases,
    2L operand buffers of padded rows, the units' partial sums, the f32
    state, two copies of the f32 residual stream, the tile table, the
    spilled units' weights."""
    tiles = (chunk_rows // 16) * (slice_width // 8)
    splits = k_splits(hidden, layers, slice_width)
    return (_align128(layers * 6 * slice_width * 4)
            + _align128(2 * layers * chunk_rows * (hidden + 8) * 2)
            + _align128(layers * tiles * 2 * splits * 384 * 4)
            + _align128(layers * tiles * 128 * 4)
            + _align128(2 * layers * tiles * 128 * 4)
            + _align128(layers * tiles * 2 * 4)
            + _align128(spilled_units(hidden, layers, slice_width)
                        * _ceil_div(hidden // 16, splits) * FRAG_TILE_BYTES))


@functools.lru_cache(maxsize=None)
def plan_launch(batch: int, hidden: int, layers: int, sms: int = H100_SMS,
                smem_limit: int = H100_SMEM_BYTES) -> GruPlan:
    """Lay a [batch, hidden] x ``layers`` recurrence over ``sms`` SMs of
    ``smem_limit`` bytes each (one block per SM). Tried in this order, the
    first that fits a row group's blocks onto the card and a 16-row block's
    operands into shared memory: every unit's weights in registers with the
    fewest layer groups (one: every block holds every layer), and within
    that the slice widths of SLICE_WIDTHS; then the same with units spilled
    into shared memory. Rows are spread over as many row groups as the card
    holds beside each other, in chunks as large as shared memory takes (at
    most MAX_CHUNK_ROWS), and what is left over goes through further passes.
    Any batch fits; on an H100 every stack that the JAX package's kernel
    takes fits (hidden up to 1024 at one layer); beyond what fits the call
    raises ValueError."""
    if batch < 1 or layers < 1 or hidden < 16 or hidden % 16:
        raise ValueError("gru_stack: batch %d, hidden %d (a multiple of 16), layers %d"
                         % (batch, hidden, layers))
    for spill in (False, True):
        for layer_groups in range(1, layers + 1):
            per_block = _ceil_div(layers, layer_groups)
            if _ceil_div(layers, per_block) != layer_groups:
                continue                     # the same cut as fewer groups
            for width in SLICE_WIDTHS:
                slices = hidden // width
                if (slices * layer_groups > sms
                        or (not spill and not fits_registers(hidden, per_block, width))
                        or smem_bytes(hidden, per_block, width, 16) > smem_limit):
                    continue
                side_by_side = sms // (slices * layer_groups)
                rows = min(MAX_CHUNK_ROWS, 16 * _ceil_div(_ceil_div(batch, 16), side_by_side))
                while smem_bytes(hidden, per_block, width, rows) > smem_limit:
                    rows -= 16
                # even the chunks out: no more rows a chunk than that many chunks need
                rows = 16 * _ceil_div(_ceil_div(batch, _ceil_div(batch, rows)), 16)
                chunks = _ceil_div(batch, rows)
                groups = min(side_by_side, chunks)
                return GruPlan(
                    slice_width=width, slices=slices, layer_groups=layer_groups,
                    block_layers=per_block, chunk_rows=rows, chunks=chunks, groups=groups,
                    passes=_ceil_div(chunks, groups), blocks=groups * slices * layer_groups,
                    k_splits=k_splits(hidden, per_block, width),
                    spilled_units=spilled_units(hidden, per_block, width),
                    smem_bytes=smem_bytes(hidden, per_block, width, rows),
                    exchange_elems=chunks * (4 * layers - 2 + 4 * (layer_groups - 1))
                    * rows * hidden,
                    layers=layers)
    raise ValueError("gru_stack: hidden %d x %d layers fits no block's shared memory "
                     "(%d bytes) or no card of %d SMs, at any slice width and layer groups"
                     % (hidden, layers, smem_limit, sms))


def plan_for(x, layers: int) -> GruPlan:
    """The plan of a launch on x [T, B, H] (a CUDA tensor), for its card."""
    props = torch.cuda.get_device_properties(x.device)
    return plan_launch(x.shape[1], x.shape[2], layers, sms=props.multi_processor_count)


def gru_stack(h0, x, wx, bx, wh, bh, return_hidden: bool = False):
    """Run the L-layer GRU recurrence over T steps: (y, h_final), or
    (y, hs, h_final) with ``return_hidden``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    global launches, launches_hs
    if x.device.type == "cpu":
        return gru_stack_ref(h0, x, wx, bx, wh, bh, return_hidden)
    if x.dim() != 3 or h0.dim() != 3:
        raise ValueError("gru_stack: x must be [T,B,H] and h0 [L,B,H]")
    t_len, b, hidden = x.shape
    layers = h0.shape[0]
    if hidden % 16:
        raise ValueError("gru_stack: hidden %d is not a multiple of 16" % hidden)
    _build.require_cuda(x, "gru_stack x", torch.bfloat16, aligned=True)
    _build.require_cuda(h0, "gru_stack h0", torch.float32, (layers, b, hidden))
    for name, w in (("wx", wx), ("wh", wh)):
        _build.require_cuda(w, "gru_stack " + name, torch.bfloat16,
                            (layers, hidden, 3 * hidden), aligned=True)
    for name, v in (("bx", bx), ("bh", bh)):
        _build.require_cuda(v, "gru_stack " + name, torch.float32, (layers, 3 * hidden))
    plan = plan_for(x, layers)
    # the barrier counter of a group only grows: one count per block and barrier
    if plan.barriers(t_len) * plan.group_blocks >= 2 ** 32:
        raise ValueError("gru_stack: T = %d is too long for one launch" % t_len)
    lib = _build.library()
    y = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    # allocated per call: at B = 128, T = 125 it is 49 MB, not worth keeping
    hs = (torch.empty((t_len, layers, b, hidden), dtype=torch.float32, device=x.device)
          if return_hidden else None)
    exchange = torch.empty(plan.exchange_elems, dtype=torch.bfloat16, device=x.device)
    counters = torch.zeros(plan.groups, dtype=torch.int32, device=x.device)
    status = lib.koala_gru_stack(
        x.data_ptr(), h0.data_ptr(), wx.data_ptr(), bx.data_ptr(), wh.data_ptr(),
        bh.data_ptr(), y.data_ptr(), hs.data_ptr() if return_hidden else None,
        h_final.data_ptr(), exchange.data_ptr(), counters.data_ptr(), t_len, b, hidden,
        layers, plan.slice_width, plan.block_layers, plan.chunk_rows, plan.chunks, plan.groups,
        _build.stream_handle(x.device))
    if return_hidden:
        launches_hs += 1
    else:
        launches += 1
    _build.check(status, "koala_gru_stack")
    return (y, hs, h_final) if return_hidden else (y, h_final)


def bound(t_len: int, b: int, h: int, layers: int, hidden_out: bool):
    """Least time (ms) of the GRU stack on an H100 (``profiling.bound``): x
    and y bf16, h in and out f32, the weights once, and with ``hidden_out``
    the streamed states hs [T, L, B, H] f32; bf16 products on the tensor
    cores beside the f32 gate math."""
    n_bytes = (2 * t_len * b * h * 2 + 2 * layers * b * h * 4
               + 2 * layers * h * 3 * h * 2 + 2 * layers * 3 * h * 4
               + (t_len * layers * b * h * 4 if hidden_out else 0))
    mm = t_len * layers * 2 * (2 * b * h * 3 * h)
    ew = t_len * layers * b * h * 16 + t_len * layers * b * 3 * h * 2
    return profiling.bound(n_bytes, mm, ew)


def grid_barriers(plan: GruPlan, count: int, device) -> None:
    """Launch ``count`` grid barriers and nothing else on the grid of
    ``plan``: the chain of barriers that a ``gru_stack`` launch cannot go
    below. For timing; it is not a launch of the GRU kernel."""
    counters = torch.zeros(plan.groups, dtype=torch.int32, device=device)
    status = _build.library().koala_grid_barriers(
        counters.data_ptr(), plan.group_blocks, plan.groups, count,
        _build.stream_handle(device))
    _build.check(status, "koala_grid_barriers")


def _round_bf16(t):
    """The cotangent of a bf16 operand comes back rounded to bf16."""
    return t.bfloat16().float()


def gru_stack_backward(h0, x, wx, bx, wh, bh, hs, ct_y, ct_hf):
    """Reverse-time pass of the stack over the streamed states ``hs``:
    cotangents (ct_y [T,B,H], ct_hf [L,B,H]) -> (dh0, dx, dwx, dbx, dwh, dbh),
    all float32. Nothing of the recurrence is run again: the state before
    step t is h0 or hs[t-1], each layer's input is x[t] plus the states below
    it, so every gate is recomputed for all T at once (four large products),
    and only the two cotangent products per layer and step stay sequential.
    The weight gradients are summed over T by one product each."""
    t_len, layers = hs.shape[0], hs.shape[1]
    wxf, whf = wx.bfloat16().float(), wh.bfloat16().float()
    bx, bh = bx.float(), bh.float()
    h_prev = torch.cat([h0.float().unsqueeze(0), hs[:-1]], dim=0)        # [T,L,B,H]
    # layer inputs: x_f accumulates the states below in f32, re-cast to bf16
    x_f = x.bfloat16().float()
    x_in = []
    for l in range(layers):
        x_in.append(x_f.bfloat16().float())
        x_f = x_f + hs[:, l]
    hb = h_prev.bfloat16().float()
    gx, gh, zs = [], [], []
    for l in range(layers):
        xp = x_in[l] @ wxf[l] + bx[l]
        hp = hb[:, l] @ whf[l] + bh[l]
        xz, xr, xn = xp.chunk(3, dim=-1)
        hz, hr, hn = hp.chunk(3, dim=-1)
        z = torch.sigmoid(xz + hz)
        r = torch.sigmoid(xr + hr)
        n = torch.tanh(xn + r * hn)
        # h' = (1-z) n + z h: d(pre-activation) per unit of dh'
        a_n = (1.0 - z) * (1.0 - n * n)
        a_z = (h_prev[:, l] - n) * z * (1.0 - z)
        a_r = a_n * hn * r * (1.0 - r)
        gx.append(torch.cat([a_z, a_r, a_n], dim=-1))                    # -> d xp
        gh.append(torch.cat([a_z, a_r, a_n * r], dim=-1))                # -> d hp
        zs.append(z)
    wxt = wxf.transpose(1, 2).contiguous()
    wht = whf.transpose(1, 2).contiguous()
    dxp = [torch.empty_like(g) for g in gx]
    dhp = [torch.empty_like(g) for g in gh]
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dh = ct_hf.float()
    ct_y = ct_y.bfloat16().float()
    for t in range(t_len - 1, -1, -1):
        dxf = ct_y[t]
        dh_prev = [None] * layers
        for l in range(layers - 1, -1, -1):
            dhn3 = (dh[l] + dxf).repeat(1, 3)
            torch.mul(dhn3, gx[l][t], out=dxp[l][t])
            torch.mul(dhn3, gh[l][t], out=dhp[l][t])
            dh_prev[l] = dhn3[:, :zs[l].shape[-1]] * zs[l][t] + _round_bf16(dhp[l][t] @ wht[l])
            dxf = dxf + _round_bf16(dxp[l][t] @ wxt[l])
        dx[t] = dxf
        dh = dh_prev
    dh0 = torch.stack(dh) if t_len else ct_hf.float()
    flat = lambda a: a.reshape(-1, a.shape[-1])
    dwx = torch.stack([flat(x_in[l]).t() @ flat(dxp[l]) for l in range(layers)])
    dwh = torch.stack([flat(hb[:, l]).t() @ flat(dhp[l]) for l in range(layers)])
    dbx = torch.stack([flat(dxp[l]).sum(0) for l in range(layers)])
    dbh = torch.stack([flat(dhp[l]).sum(0) for l in range(layers)])
    return dh0, dx, dwx, dbx, dwh, dbh


class _GruStackTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h0, x, wx, bx, wh, bh):
        y, hs, h_final = gru_stack(
            h0.float().contiguous(), x.bfloat16().contiguous(), wx.bfloat16().contiguous(),
            bx.float().contiguous(), wh.bfloat16().contiguous(), bh.float().contiguous(),
            return_hidden=True)
        ctx.save_for_backward(h0, x, wx, bx, wh, bh, hs)
        return y, h_final

    @staticmethod
    def backward(ctx, ct_y, ct_hf):
        h0, x, wx, bx, wh, bh, hs = ctx.saved_tensors
        grads = gru_stack_backward(h0, x, wx, bx, wh, bh, hs, ct_y, ct_hf)
        # each gradient in its input's dtype (dx in x's, as the JAX backward)
        return tuple(g.to(inp.dtype)
                     for g, inp in zip(grads, (h0, x, wx, bx, wh, bh)))


def gru_stack_trainable(h0, x, wx, bx, wh, bh):
    """Differentiable ``gru_stack``: (y [T,B,H] bf16, h_final [L,B,H] f32).
    Forward is the ``return_hidden`` kernel (the plain version for CPU
    tensors), backward ``gru_stack_backward`` over the states it streamed
    out. The weights may be float32 (they are rounded to bf16 for the
    products, and their gradients come back float32)."""
    return _GruStackTrainable.apply(h0, x, wx, bx, wh, bh)


__all__ = ["gru_stack", "gru_stack_ref", "gru_stack_trainable", "gru_stack_backward",
           "layers_step", "GruPlan", "plan_launch", "plan_for", "grid_barriers", "bound"]
