"""The launch plan of the port's GRU-stack kernel (ops/kernels/gru.py
``plan_launch``) and the schedule it stands for.

The kernel itself runs only on a card (tests/test_torch_cuda.py); what is
Python is held here: every hidden unit and every row has exactly one owner,
a block fits an SM, the grid fits the card, and a plain model of the kernel's
data flow (column slices, exchange buffers chosen by parity, a wavefront over
the layers with one barrier a tick) computes what ``gru_stack_ref`` computes.
"""

import numpy as np
import pytest
import torch

from koala_tpu_torch.ops.kernels import gru

SMS, SMEM = 132, 232448


@pytest.mark.parametrize("batch", [1, 17, 64, 128, 300])
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("hidden", [64, 128, 384])
def test_plan_owns_everything_once_and_fits(hidden, layers, batch):
    plan = gru.plan_launch(batch, hidden, layers)
    assert plan.slice_width in (8, 16) and plan.slices * plan.slice_width == hidden
    # every hidden unit belongs to exactly one block of a row group
    owners = np.zeros(hidden, int)
    for j in range(plan.slices):
        a, b = plan.slice_range(j)
        owners[a:b] += 1
    assert (owners == 1).all()
    # every row belongs to exactly one chunk, every chunk to exactly one group
    rows = np.zeros(batch, int)
    walked = []
    for g in range(plan.groups):
        chunks = plan.group_chunks(g)
        assert 1 <= len(chunks) <= plan.passes
        walked += chunks
        for c in chunks:
            a, b = plan.chunk_range(c, batch)
            assert 0 <= a < b <= batch and b - a <= plan.chunk_rows
            rows[a:b] += 1
    assert (rows == 1).all() and sorted(walked) == list(range(plan.chunks))
    assert max(len(plan.group_chunks(g)) for g in range(plan.groups)) == plan.passes
    assert plan.chunk_rows % 16 == 0 and 16 <= plan.chunk_rows <= gru.MAX_CHUNK_ROWS
    # one block an SM, all of them resident at once
    assert plan.blocks == plan.groups * plan.slices <= SMS
    assert plan.smem_bytes == gru.smem_bytes(hidden, layers, plan.slice_width,
                                             plan.chunk_rows) <= SMEM
    # every unit of the block's products has a warp, and its weights fit that
    # warp's registers; the k ranges cover every k tile once
    assert gru.units(hidden, layers, plan.slice_width) <= gru.WARPS
    k_tiles = hidden // 16
    edges = [s * k_tiles // plan.k_splits for s in range(plan.k_splits + 1)]
    assert edges[0] == 0 and edges[-1] == k_tiles
    assert all(0 < b - a <= gru.UNIT_K_TILES for a, b in zip(edges, edges[1:]))
    # two copies of bf16(h_l) for every layer and of bf16(x_l) for every layer
    # but the first, per chunk
    assert plan.exchange_elems == plan.chunks * (4 * layers - 2) * plan.chunk_rows * hidden
    assert plan.exchange_elems * 2 < 64 << 20


def test_plan_main_path_shapes():
    """The shapes of the serving and the training path: the whole batch in
    flight at once, one pass."""
    for batch, rows in ((64, 16), (128, 32)):
        plan = gru.plan_launch(batch, 384, 2)
        assert (plan.slice_width, plan.slices, plan.chunk_rows) == (16, 24, rows)
        assert (plan.groups, plan.passes, plan.blocks) == (4, 1, 96)
    assert gru.plan_launch(64, 384, 2).barriers(376) == 1 + 376
    assert gru.plan_launch(64, 384, 2).barriers(0) == 1
    assert gru.plan_launch(300, 384, 2).barriers(10) == 2 * 11


def test_plan_small_card_takes_more_passes():
    plan = gru.plan_launch(300, 384, 2, sms=30)
    assert plan.groups == 1 and plan.blocks == 24 and plan.passes == plan.chunks == 10
    assert plan.chunk_rows == 32        # 48 rows of operands and partial sums overflow an SM
    assert gru.smem_bytes(384, 2, 16, 48) > SMEM >= plan.smem_bytes
    assert gru.plan_launch(300, 64, 1, sms=4).chunk_rows == 64


def test_plan_falls_back_to_the_narrow_slice():
    """Three layers of 384 at 16 units a block would need 24 warps: the plan
    takes 8 units a block (48 blocks a group, 12 units of 12 k tiles)."""
    assert not gru.fits_registers(384, 3, 16) and gru.fits_registers(384, 3, 8)
    plan = gru.plan_launch(64, 384, 3)
    assert plan.slice_width == 8 and plan.slices == 48 and plan.blocks <= SMS


@pytest.mark.parametrize("batch,hidden,layers", [(0, 64, 1), (4, 40, 1), (4, 64, 0), (4, 8, 1)])
def test_plan_refuses_bad_shapes(batch, hidden, layers):
    with pytest.raises(ValueError):
        gru.plan_launch(batch, hidden, layers)


def test_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="fits no block"):
        gru.plan_launch(8, 4096, 3)
    with pytest.raises(ValueError, match="fits no block"):
        gru.plan_launch(8, 384, 2, sms=16)      # fewer SMs than slices


def _planned_gru_stack(plan, h0, x, wx, bx, wh, bh):
    """The kernel's data flow in plain torch. Blocks run one after the other
    inside a tick; what a block reads of other blocks comes only from the
    exchange buffers, which start as NaN so that a read of something not yet
    published shows."""
    t_len, batch, hidden = x.shape
    layers, rows, width = h0.shape[0], plan.chunk_rows, plan.slice_width
    y = torch.empty_like(x)
    hs = torch.empty((t_len, layers, batch, hidden))
    h_final = torch.empty_like(h0)
    wxf, whf = wx.float(), wh.float()
    for group in range(plan.groups):
        for chunk in plan.group_chunks(group):
            r0, r1 = plan.chunk_range(chunk, batch)
            live = r1 - r0
            hbuf = torch.full((layers, 2, rows, hidden), float("nan")).bfloat16()
            xbuf = torch.full((max(layers - 1, 1), 2, rows, hidden), float("nan")).bfloat16()
            state = torch.zeros((layers, rows, hidden))
            state[:, :live] = h0[:, r0:r1]
            stream = torch.zeros((2, layers, rows, hidden))     # f32 residual, by tick parity
            for l in range(layers):
                hbuf[l, (l + 1) & 1] = state[l].bfloat16()
            for k in range(t_len + layers - 1 if t_len else 0):
                cur, prev = k & 1, (k + 1) & 1
                for j in range(plan.slices):
                    a, b = plan.slice_range(j)
                    cols = torch.cat([torch.arange(a, b) + g * hidden for g in range(3)])
                    for l in range(layers):
                        t = k - l
                        if not 0 <= t < t_len:
                            continue
                        if l == 0:
                            xop = torch.zeros((rows, hidden), dtype=torch.bfloat16)
                            xop[:live] = x[t, r0:r1]
                            x_in = xop[:, a:b].float()
                        else:
                            xop = xbuf[l - 1, prev]
                            x_in = stream[prev, l, :, a:b]
                        hop = hbuf[l, prev]
                        assert not (xop.isnan().any() or hop.isnan().any())
                        xp = xop.float() @ wxf[l][:, cols] + bx[l][cols]
                        hp = hop.float() @ whf[l][:, cols] + bh[l][cols]
                        h_new = gru._gates(state[l, :, a:b], hp, xp)
                        x_new = x_in + h_new
                        state[l, :, a:b] = h_new
                        hbuf[l, cur, :, a:b] = h_new.bfloat16()
                        if l < layers - 1:
                            stream[cur, l + 1, :, a:b] = x_new
                            xbuf[l, cur, :, a:b] = x_new.bfloat16()
                        else:
                            y[t, r0:r1, a:b] = x_new[:live].bfloat16()
                        hs[t, l, r0:r1, a:b] = h_new[:live]
            h_final[:, r0:r1] = state[:, :live]
    return y, hs, h_final


@pytest.mark.parametrize("batch,hidden,layers,sms", [
    (5, 64, 1, 132), (40, 64, 2, 132), (21, 64, 3, 132), (150, 64, 2, 8), (70, 32, 2, 2)])
def test_planned_schedule_matches_plain(batch, hidden, layers, sms):
    """A plain model of the kernel's slices, exchange buffers and wavefront
    against ``gru_stack_ref``. A product over a slice's columns sums in
    another order than the product over all columns, so a bf16 rounding of
    the stream may flip: the tolerances of tests/test_torch_gru.py."""
    rng = np.random.default_rng(batch + hidden + layers)
    t_len = 7

    def randn(*shape, scale):
        return torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32))

    h0 = randn(layers, batch, hidden, scale=0.2)
    x = randn(t_len, batch, hidden, scale=0.3).bfloat16()
    wx = randn(layers, hidden, 3 * hidden, scale=1.5 / hidden ** 0.5).bfloat16()
    wh = randn(layers, hidden, 3 * hidden, scale=1.5 / hidden ** 0.5).bfloat16()
    bx, bh = randn(layers, 3 * hidden, scale=0.1), randn(layers, 3 * hidden, scale=0.1)
    plan = gru.plan_launch(batch, hidden, layers, sms=sms)
    if sms < 132:
        assert plan.passes > 1
    y, hs, h_final = _planned_gru_stack(plan, h0, x, wx, bx, wh, bh)
    ry, rhs, rh = gru.gru_stack_ref(h0, x, wx, bx, wh, bh, return_hidden=True)
    np.testing.assert_allclose(y.float().numpy(), ry.float().numpy(), atol=8e-3, rtol=0)
    np.testing.assert_allclose(hs.numpy(), rhs.numpy(), atol=2e-4, rtol=0)
    np.testing.assert_allclose(h_final.numpy(), rh.numpy(), atol=2e-4, rtol=0)
    assert torch.equal(hs[-1], h_final)
