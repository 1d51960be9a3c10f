"""The fixed-order product's dispatch on the CPU: ``rowmm.plan`` (which
kernel, block and grid a shape takes), ``row_layout`` (which views of A the
kernels read without a copy) and the mirror of csrc/rowmm.cu's table of
variants. The kernels themselves run only on a card
(tests/test_torch_cuda.py holds every variant to the first design bit for
bit)."""

import os
import re

import numpy as np
import pytest
import torch

from koala_tpu_torch.models import params_io
from koala_tpu_torch.engine.stream import load_model
from koala_tpu_torch.ops.kernels import rowmm

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "koala_tpu_torch", "csrc", "rowmm.cu")
# (K, N) of the port's frame-local products: the STFT's two bases, the
# iSTFT's two, the band pool, the cepstral basis, the encoder, decoder and
# gate of the bundled model, and the scan branch's wx and wh
SITES = [(512, 257), (257, 512), (257, 32), (257, 161), (329, 384), (384, 257), (384, 1),
         (384, 1152)]
# rows of the call sites: one stream's frame, the battery's 21 streams, the
# main path's 64, a round of 8 frames of the battery, one stream's 376
# frames, the battery's 365 frames in one call, the main path's 376 x 64,
# bench_torch.py's 512 x 376; and the one-row kernel's limit and one past it
ROWS = (1, 21, 64, 8 * 21, 376, 365 * 21, 376 * 64, 512 * 376,
        rowmm.ROW_MAX - 1, rowmm.ROW_MAX, rowmm.ROW_MAX + 1)
GRID_X_MAX = 2 ** 31 - 1


@pytest.mark.parametrize("k,n", SITES)
def test_every_call_site_and_row_count_has_a_plan(k, n):
    """Each shape gets a variant of the table whose blocks cover the product
    exactly (no block wholly past the last row or column)."""
    for m in ROWS:
        p = rowmm.plan(m, n, k)
        name, rows, cols, threads = rowmm.VARIANTS[p.variant]
        assert (p.name, p.threads) == (name, threads)
        assert (p.grid[0] - 1) * rows < m <= p.grid[0] * rows, (m, n, k, p)
        assert (p.grid[1] - 1) * cols < n <= p.grid[1] * cols, (m, n, k, p)
        assert p.variant != rowmm.COL or n == 1


@pytest.mark.parametrize("n", sorted({n for _, n in SITES}))
def test_grids_stay_within_cuda_limits(n):
    """Up to bench_torch.py's 512 x 376 rows the grid fits CUDA's limits:
    2**31 - 1 blocks over rows, 65535 over columns, at most 1024 threads."""
    for m in (1, 2, 31, 33, 97, rowmm.ROW_MAX, rowmm.ROW_MAX + 1, 2048, 2049, 24064,
              512 * 376):
        p = rowmm.plan(m, n, 384)
        assert 1 <= p.grid[0] <= GRID_X_MAX and 1 <= p.grid[1] <= rowmm.GRID_Y_MAX
        assert 32 <= p.threads <= 1024 and p.threads % 32 == 0


def test_plan_depends_only_on_the_shape():
    """The plan is a value of (m, n, k) alone: the same shape gives the same
    plan with the cache emptied, and K (every variant takes any K) does not
    move it."""
    first = {(m, n, k): rowmm.plan(m, n, k) for m in ROWS for k, n in SITES}
    rowmm.plan.cache_clear()
    for (m, n, k), p in first.items():
        assert rowmm.plan(m, n, k) == p
        for other_k in (0, 1, 3, 33, 1152):
            assert rowmm.plan(m, n, other_k) == p


def test_threshold_is_where_the_docstring_says():
    """Up to ROW_MAX rows (named in plan's docstring) a one-row kernel
    (narrow or row), one row more a tile; a product of one column never
    takes a tile; the step's single row takes the narrowest kernel."""
    assert "ROW_MAX = %d" % rowmm.ROW_MAX in rowmm.plan.__doc__
    for k, n in SITES:
        below, above = rowmm.plan(rowmm.ROW_MAX, n, k), rowmm.plan(rowmm.ROW_MAX + 1, n, k)
        assert below.name.startswith(("narrow", "row")), (k, n, below)
        if n == 1:
            assert not above.name.startswith("tile"), (k, n, above)
        else:
            assert above.name.startswith("tile"), (k, n, above)
        assert rowmm.plan(1, n, k).name == "narrow<4,128,4>"


def test_the_variant_table_mirrors_the_kernels():
    """csrc/rowmm.cu's VARIANTS table (rows, columns, threads) and its launch
    switch name the variants that rowmm.VARIANTS names, in the same order."""
    src = open(CSRC).read()
    table = src[src.index("constexpr Variant VARIANTS[] = {"):]
    table = table[:table.index("};")]
    rows = re.findall(r"\{(\w+), (\w+), (\w+)\},\s*// (\d+) (\S+)", table)
    consts = {name: int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))
              for name in ("COL_ROWS", "NAR_COLS", "NAR_WARPS")}
    consts["NAR_THREADS"] = 32 * consts["NAR_WARPS"]

    def value(x):
        return consts[x] if x in consts else int(x)
    got = [(int(i), name, value(r), value(c), value(t)) for r, c, t, i, name in rows]
    assert [(i, r, c, t) for i, _, r, c, t in got] == \
        [(i, r, c, t) for i, (_, r, c, t) in enumerate(rowmm.VARIANTS)]
    cases = re.findall(r"case (\d+):\s*rowmm_(narrow|row|col|tile)_kernel(<[^>]*>)?", src)
    cases.append((str(len(rowmm.VARIANTS) - 1),)
                 + re.search(r"default:\s*rowmm_(tile)_kernel(<[^>]*>)", src).groups())
    for i, kind, targs in cases:
        name = rowmm.VARIANTS[int(i)][0]
        assert name.startswith(kind), (i, kind, name)
        if kind in ("narrow", "row"):
            assert name == "%s<%s>" % (kind, targs.strip("<>").replace(" ", ""))
        if kind == "tile":
            bm, bn = targs.strip("<>").split(", ")[:2]
            assert name == "tile<%s,%s>" % (bm, bn)
    assert len(cases) == len(rowmm.VARIANTS)


def test_plan_for_refuses_the_column_kernel_at_more_columns():
    assert rowmm.plan_for(rowmm.COL, 24064, 1).name == "col"
    with pytest.raises(ValueError):
        rowmm.plan_for(rowmm.COL, 24064, 2)


def _row_offsets(a):
    """Element offset of each of a's flattened rows from a's first element."""
    lead = a.shape[:-1]
    idx = np.array(np.unravel_index(np.arange(int(np.prod(lead, dtype=np.int64))), lead)) \
        if lead else np.zeros((0, 1), np.int64)
    return (np.array(a.stride()[:-1], np.int64)[:, None] * idx).sum(axis=0) if lead else \
        np.zeros(1, np.int64)


@pytest.mark.parametrize("view", ["contiguous", "permuted", "row_strided", "one_row",
                                  "expanded", "unit_axes"])
def test_row_layout_gives_every_row_its_place(view):
    """Where ``row_layout`` takes a view, (r // inner) * s_outer + (r %
    inner) * s_inner is row r's offset, as the kernels read it."""
    base = torch.arange(6 * 5 * 8, dtype=torch.float32)
    a = {"contiguous": base.view(6, 5, 8),
         "permuted": base.view(5, 6, 8).transpose(0, 1),         # [B, T, K] of [T, B, K]
         "row_strided": base.view(30, 8)[:, :3],
         "one_row": base.view(30, 8)[4],
         "expanded": base.view(30, 8)[:5].expand(3, 5, 8),
         "unit_axes": base.view(5, 6, 8).transpose(0, 1)[:, None, :, None, :].squeeze(3),
         }[view]
    inner, s_outer, s_inner = rowmm.row_layout(a)
    r = np.arange(max(int(np.prod(a.shape[:-1], dtype=np.int64)), 1))
    np.testing.assert_array_equal((r // inner) * s_outer + (r % inner) * s_inner, _row_offsets(a))


def test_row_layout_refuses_what_the_kernels_do_not_take():
    base = torch.arange(4 * 5 * 6 * 8, dtype=torch.float32)
    assert rowmm.row_layout(base.view(32, 30).t()) is None                 # K not contiguous
    assert rowmm.row_layout(base.view(4, 5, 6, 8).permute(1, 0, 2, 3)) is None   # three strides


def test_matmul_takes_a_permuted_view_as_it_lies():
    """The decoder's and the gate's input, a [B, T, H] view of the GRU's
    [T, B, H] output, gives the bits of its contiguous copy (on the CPU the
    plain version; on a card the kernels read it in place)."""
    rng = np.random.default_rng(5)
    y = torch.as_tensor(rng.standard_normal((7, 3, 384)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((384, 257)).astype(np.float32)) * 0.05
    view = y.transpose(0, 1)
    assert rowmm.row_layout(view) == (7, 384, 3 * 384)
    with torch.inference_mode():
        assert torch.equal(rowmm.matmul(view, w), rowmm.matmul(view.contiguous(), w))


def test_rounded_weights_are_contiguous():
    """The bundled model's decoder weight is held transposed; its cached
    bf16-rounded copy (the decoder product's b) is contiguous, so the
    product makes no copy of it a call."""
    _, params = load_model(params_io.default_model_path(), "cpu")
    cfg = {"compute_dtype": "bfloat16"}
    with torch.inference_mode():
        for name in ("enc.w", "dec.w", "gate.w"):
            w = params.rounded(name, cfg)
            assert w.is_contiguous() and torch.equal(
                w, params.get_parameter(name).bfloat16().float()), name
