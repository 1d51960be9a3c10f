"""The `fullsubnet` configuration's pieces on the CPU: its frozen counts
against the program's `bound()`, its plain reference against the port's CPU
route and its control against the cell's limit, a tiny cell through the
harness (its span readers with and without the program's spans), and the
faults it must see."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import audio, compare
from benchmark.counts import fullsubnet as counts
from benchmark.counts import peaks
from benchmark.reference import fullsubnet as ref
from benchmark.reference.pv import read_pv
from conftest import BENCH, REPO, make_tiny_root, run_tiny

CELL = "fullsubnet.wash.b2048"
TINY_CELL = "fullsubnet-tiny.wash.tiny"


def _config():
    with open(os.path.join(BENCH, "configs", "fullsubnet.json")) as f:
        return json.load(f)


FSN = _config()["model"]
TINY_WIDTHS = {"fb_hidden": 32, "sb_hidden": 16}


def _hops(b, t, seed=5):
    bank = audio.Bank(REPO, "cpu")
    plan = audio.Plan(np.random.default_rng(seed), b, bank.length)
    return audio.mix_blocks(bank, plan, t * 256).reshape(b, t, 256)


def _write_tiny_model(path, seed=3):
    from koala_tpu_torch.models import fullsubnet, params_io
    cfg = dict(FSN, **TINY_WIDTHS)
    params_io.save_params(path, fullsubnet.init_params(torch.Generator().manual_seed(seed), cfg),
                          cfg)
    return cfg


# -- counts -----------------------------------------------------------------


def test_frame_products_at_the_recipes_widths():
    model, spectral = counts.frame_products(FSN, False)
    assert model == (942774784, "bfloat16") and spectral == (1052672, "float32")
    assert counts.frame_products(FSN, True) == counts.frame_products(FSN, False)
    # a batch of 2048 x 375 hops: 724 TFLOP, 0.73 s at the bf16 peak, and the STFT at f32's
    assert round(2048 * 375 * model[0] / 1e12) == 724
    assert peaks.product_s([model, spectral]) * 2048 * 375 == pytest.approx(0.7442, abs=1e-4)


def test_lstm_counts_are_the_kernels_bound():
    from koala_tpu_torch.ops.kernels import lstm
    for rows in (1, 2048, 64):
        fb = sum(max(lstm.bound(rows, kx, 512).values()) for kx in (257, 512))
        sb = sum(max(lstm.bound(rows * 257, kx, 384).values()) for kx in (32, 384))
        assert counts.lstm_s(FSN, rows, 375) * 1e3 == pytest.approx(375 * (fb + sb), rel=1e-12)
    # a batch of 2048 streams: 0.85 s, the sub-band's two layer-steps nearly all of it
    assert counts.lstm_s(FSN, 2048, 375) == pytest.approx(0.8463, abs=1e-4)


def test_rowmm_counts_are_rowmms_bound():
    from koala_tpu_torch.ops.kernels import rowmm
    m = 2048 * 375
    want = sum(max(rowmm.bound(m, k, n).values()) for k, n in counts.unfused_products(FSN))
    want += sum(max(rowmm.bound(m * r, k, n).values())
                for r, k, n in counts.model_rowmm_products(FSN))
    assert counts.rowmm_s(FSN, m) * 1e3 == pytest.approx(want, rel=1e-12)


# -- the reference ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fsn") / "fsn_tiny.pv")
    return path, _write_tiny_model(path)


def test_reference_matches_the_cpu_route(tiny_model):
    """The port's CPU route (the kernels' plain versions) against the plain
    reference, both at bf16 products: within the rounding of bf16."""
    from koala_tpu_torch.engine.core import make_engine
    from koala_tpu_torch.models import params_io
    path, _ = tiny_model
    hops = _hops(3, 30)
    tree, cfg = params_io.load_params(path)
    eng = make_engine("fullsubnet", cfg)
    params = params_io.params_from_numpy(tree, "cpu", "fullsubnet")
    with torch.inference_mode():
        _, out = eng.sequence(params, eng.init_state((3,), "cpu"), hops)
    flat, file_cfg = read_pv(path)
    want = ref.Reference({"model": file_cfg}, path, "cpu").enhance(
        hops, {"products": "bfloat16", "spectral": "float32"})
    assert torch.equal(want, ref.enhance(ref.Weights(flat, file_cfg, "cpu"), hops, "bfloat16",
                                         "float32"))
    worst = max(float(np.sqrt(e[0] / e[1])) for e in (compare.errors(o.numpy(), r.numpy())
                                                      for o, r in zip(out, want)))
    assert worst < 1e-3


class _Run:
    def __init__(self, model_path):
        self.config = dict(_config(), model=dict(FSN, **TINY_WIDTHS))
        with open(os.path.join(BENCH, "cells", CELL + ".json")) as f:
            self.limits = json.load(f)["limits"]
        self.model_path = model_path
        self.device = torch.device("cpu")


def test_control_fails_the_cells_limit(tiny_model):
    """The fp8 control in the program's place on 4 streams of 60 hops reads
    past the cell's limit; the reference itself reads 0."""
    run = _Run(tiny_model[0])
    items = [{"hops": h.numpy(), "out": None, "fused_hops": 0} for h in _hops(4, 60, seed=11)]
    ctrl = compare.compare(run, compare.control_items(run, items), run.config["precision"])
    assert any(ctrl[k] > v for k, v in run.limits.items()), (ctrl, run.limits)
    refs = compare.reference_outputs(compare.reference(run), items, run.config["precision"], "cpu")
    same = compare.compare(run, [dict(it, out=r) for it, r in zip(items, refs)],
                           run.config["precision"])
    assert same["err_rms"] == 0.0


def test_neighbours_reflect_at_both_edges():
    idx = ref.neighbours(257, 15)
    assert idx.shape == (257, 31)
    assert list(idx[0, :16]) == list(range(15, -1, -1))
    assert list(idx[256, 15:]) == list(range(256, 240, -1))
    assert list(idx[100]) == list(range(85, 116))


# -- a tiny cell through the harness --------------------------------------------


def make_fsn_root(path):
    """The tiny root with a tiny FullSubNet configuration (the real one at
    full band 32, sub band 16, its model file written here) and its cell,
    which takes the real cell's limits and metric lists."""
    root = make_tiny_root(path)
    bench = os.path.join(root, "benchmark")
    os.makedirs(os.path.join(root, "tiny_models"))
    cfg = _config()
    cfg["name"] = "fullsubnet-tiny"
    cfg["model_file"] = "tiny_models/fullsubnet_tiny.pv"
    cfg["model"] = _write_tiny_model(os.path.join(root, cfg["model_file"]))
    with open(os.path.join(bench, "configs", "fullsubnet-tiny.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(bench, "cells", CELL + ".json"),
                os.path.join(bench, "cells", TINY_CELL + ".json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": TINY_CELL, "config": "fullsubnet-tiny",
                              "traffic": "wash.tiny", "chips": 1, "why": "a tiny cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="module")
def fsn_root(tmp_path_factory):
    return make_fsn_root(tmp_path_factory.mktemp("bench_fsn"))


def test_tiny_cell_prints_the_line(fsn_root):
    rc, line, err = run_tiny(fsn_root, TINY_CELL, seconds=1.0)
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0, line["compared"]
    assert set(line["metrics"]) == {"batch_audio_s_per_s", "setup_s"}


def test_traced_tiny_cell_reads_the_subband_span(fsn_root):
    rc, line, err = run_tiny(fsn_root, TINY_CELL, seconds=1.0, trace=1)
    assert rc == 0 and line["correct"] is True, err
    assert line["metrics"]["subband_host_ms.batch"]["value"] > 0
    assert line["metrics"]["subband_host_ms.batch"]["unit"] == "ms"
    # device readers give nothing without a card; the other host readers read
    assert {"upload_host_ms.batch", "launch_host_ms.batch"} <= set(line["metrics"])


class _Trace:
    t0, t1 = 1000, 2000
    delta = {"batches": 2}
    kernels = [("void koala::(anonymous namespace)::lstm_cell_kernel(LstmArgs)", 1100, 1300),
               ("rowmm_tile", 1300, 1400)]

    def kernel_s(self, match):
        return sum(b - a for n, a, b in self.kernels if match(n)) * 1e-9


def test_the_readers_read_the_kernel_and_the_span(monkeypatch):
    """The roofline over the kernel's time, the sub-band's host time from its
    spans; neither from a kind or a program without them."""
    from benchmark.counts import mmse
    from benchmark.harness import load_module
    from koala_tpu_torch import profiling

    class Run:
        config = {"model": FSN}
        counts = counts
        batch_rows, hops = 2048, 375
    records = [profiling.Span("fullsubnet.subband", 1150, 1350, "engine.model", 1,
                              {"frames": 1, "rows": 2048 * 257, "launches": 4}),
               profiling.Span("fullsubnet.subband", 1950, 2100, "engine.model", 1,
                              {"frames": 1, "rows": 2048 * 257, "launches": 4})]
    monkeypatch.setattr(profiling, "_records", records)
    read = {}
    for name in ("lstm_roofline.batch", "subband_host_ms.batch"):
        read[name] = load_module(os.path.join(BENCH, "metrics", name + ".py"),
                                 "bench_metric_" + name.replace(".", "_")).read
    assert read["subband_host_ms.batch"](Run, _Trace()) == pytest.approx(200e-6)
    assert read["lstm_roofline.batch"](Run, _Trace()) == pytest.approx(
        100 * 2 * counts.lstm_s(FSN, 2048, 375) / 200e-9)
    Run.counts = mmse
    assert read["lstm_roofline.batch"](Run, _Trace()) is None
    monkeypatch.delattr(profiling, "spans")
    assert read["subband_host_ms.batch"](Run, _Trace()) is None


# -- the faults the cell must see -------------------------------------------------


def _frame_wrapped(monkeypatch, before=None, after=None):
    from koala_tpu_torch.models import fullsubnet
    orig = fullsubnet._frame

    def frame(params, st, mag, cfg):
        st = before(st) if before else st
        new, mask = orig(params, st, mag, cfg)
        return (new, after(mask)) if after else (new, mask)
    monkeypatch.setattr(fullsubnet, "_frame", frame)


def _subband_reset_every_8(monkeypatch):
    """The sub-band LSTM's h and c set to zeros every 8 hops."""
    def before(st):
        if int(st["count"].flatten()[0]) % 8 == 0:
            st = dict(st, sb_h=torch.zeros_like(st["sb_h"]), sb_c=torch.zeros_like(st["sb_c"]))
        return st
    _frame_wrapped(monkeypatch, before=before)


def _norm_restarted(monkeypatch):
    """The cumulative means restarted at every call of the frame step: the
    running sums and the count from zero, each frame on its own."""
    def before(st):
        return dict(st, fb_sum=torch.zeros_like(st["fb_sum"]),
                    sb_sum=torch.zeros_like(st["sb_sum"]), count=torch.zeros_like(st["count"]))
    _frame_wrapped(monkeypatch, before=before)


def _imaginary_dropped(monkeypatch):
    """The mask's imaginary half dropped: a real mask of its real half."""
    _frame_wrapped(monkeypatch, after=lambda mask: (mask[0], torch.zeros_like(mask[1])))


@pytest.mark.parametrize("fault", [_subband_reset_every_8, _norm_restarted, _imaginary_dropped])
def test_a_fault_is_not_correct(fsn_root, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = run_tiny(fsn_root, TINY_CELL, seconds=0.5)
    assert rc == 0, err
    assert line["correct"] is False, line["compared"]
