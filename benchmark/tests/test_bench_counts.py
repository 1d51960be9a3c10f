"""The frozen operation and byte counts give the figures the program's own
`bound()`s give, and those quoted for the port's kernels."""

import json
import os

import pytest

from benchmark.counts import mask_gru, mmse, peaks
from conftest import BENCH


def _cfg(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)["model"]


GRU = _cfg("koala-gru384x2")


def test_nine_products_at_24064_rows():
    flops = sum(2 * 24064 * k * n for k, n in mask_gru.unfused_products(GRU))
    assert len(mask_gru.unfused_products(GRU)) == 9
    assert round(flops / 1e9, 1) == 38.6
    assert flops / peaks.F32_FLOPS * 1e3 == pytest.approx(0.5756, abs=5e-5)
    # each product at its own bound: the gate's (N = 1) is set by its bytes
    assert mask_gru.rowmm_s(GRU, 24064) > flops / peaks.F32_FLOPS


def test_gru_stack_at_376_64():
    _, mm, _ = mask_gru.gru_ops(GRU, 376, 64)
    assert round(mm / 1e9, 1) == 85.2
    assert mask_gru.gru_s(GRU, 376, 64) * 1e3 == pytest.approx(0.0861, abs=5e-5)


def test_fused_at_64_376():
    _, mm, _ = mask_gru.fused_ops(GRU, 64, 376)
    assert round(mm / 1e9, 1) == 123.7
    assert mask_gru.fused_s(GRU, 64, 376) * 1e3 == pytest.approx(0.1251, abs=5e-5)


def test_floor_at_376_64_32():
    assert round(mask_gru.floor_bytes(GRU, 376, 64) / 1e6, 2) == 6.18


def test_counts_match_the_programs_bounds():
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.ops.kernels import engine_fused, floor, gru, rowmm
    tree, cfg = params_io.load_params(os.path.join(os.path.dirname(BENCH), "models",
                                                   "koala_params_tpu.pv"))
    params = params_io.params_from_numpy(tree, "cpu", "mask_gru")
    for t, b in ((376, 64), (32, 1024), (1, 1024)):
        assert mask_gru.gru_s(GRU, t, b) * 1e3 == pytest.approx(
            max(gru.bound(t, b, 384, 2, False).values()), rel=1e-12)
    assert mask_gru.floor_bytes(GRU, 376, 64) / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        floor.bound(376, 64, 32)["bytes"], rel=1e-12)
    for m in (3584, 32768, 1024):
        assert mask_gru.rowmm_s(GRU, m) * 1e3 == pytest.approx(
            sum(max(rowmm.bound(m, k, n).values()) for k, n in mask_gru.unfused_products(GRU)),
            rel=1e-12)
    # operations equal; bytes differ only by the padding of the kernel's weights
    ops = engine_fused.bound(params, cfg, 512, 368)["operations"]
    assert mask_gru.fused_s(GRU, 512, 368) * 1e3 == pytest.approx(ops, rel=1e-12)


def test_mmse_products():
    per_row = mmse.frame_products(_cfg("mmse"), False)[0][0]
    assert per_row == 4 * 2 * 512 * 257
    assert round(4096 * 375 * per_row / 1e12, 2) == 1.62


def test_frame_products_by_path():
    fused = mask_gru.frame_products(GRU, True)
    plain = mask_gru.frame_products(GRU, False)
    assert sum(f for f, _ in plain) == sum(f for f, _ in fused)
    assert {p for _, p in fused} == {"bfloat16"}
    assert {p for _, p in plain} == {"bfloat16", "float32"}
    assert round(sum(f for f, _ in fused) / 1e6, 2) == 5.14
