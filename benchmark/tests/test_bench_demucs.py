"""The `demucs-dns64` configuration's pieces on the CPU: its frozen counts
against the program's `bound()`, its plain reference against the port's CPU
route and its control against the cell's limit, a tiny cell through the
harness (its readers with and without the program's spans), and the faults
it must see."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import audio, compare
from benchmark.counts import demucs as counts
from benchmark.counts import peaks
from benchmark.reference import demucs as ref
from benchmark.reference.pv import write_pv
from conftest import BENCH, REPO, make_tiny_root, run_tiny

CELL = "demucs-dns64.wash.b2048"
TINY_CELL = "demucs-tiny.wash.tiny"


def _config():
    with open(os.path.join(BENCH, "configs", "demucs-dns64.json")) as f:
        return json.load(f)


DNS64 = _config()["model"]
# The tiny configuration: dns64 at its widths. With seeded random weights the
# program's bf16 rounding flips read about 5.2e-4 against the reference, and
# the LSTM reset every 8 hops only 6.2e-4 (the random LSTM forgets within a few
# hops); narrower widths read the flips above the cell's limit (hidden 16,
# 8e-4) or the reset below it (hidden 32, 3.2e-4). The LSTM adds little to the
# random model's output: its recurrent product dropped reads 6.4e-4, but either
# half of its depth in fp8 (5.2e-4, 5.4e-4), the recurrent product dropped on
# every other row (5.9e-4) or a reset every 16 hops (5.6e-4) stay under the
# limit. The LSTM kernel's own checks against its plain version on the card
# (the card tests, chip_smoke.py) guard it at the cell's shape.
TINY = dict(DNS64)


def _hops(b, t, seed=5):
    bank = audio.Bank(REPO, "cpu")
    plan = audio.Plan(np.random.default_rng(seed), b, bank.length)
    return audio.mix_blocks(bank, plan, t * 256).reshape(b, t, 256)


# -- counts -----------------------------------------------------------------


def test_frame_products_at_the_published_widths():
    model, resample = counts.frame_products(DNS64, False)
    # 71.57M MACs a stream-hop in the convolutions and the LSTM, 0.17M in the resampling
    assert model == (143130624, "bfloat16") and resample == (344576, "float32")
    assert counts.frame_products(DNS64, True) == counts.frame_products(DNS64, False)
    # a batch of 2048 x 375 hops: 110.2 TFLOP
    assert round(2048 * 375 * (model[0] + resample[0]) / 1e11) == 1102
    assert peaks.product_s([model, resample]) * 2048 * 375 == pytest.approx(0.11510, abs=1e-5)


def test_lstm_counts_are_the_kernels_bound():
    from koala_tpu_torch.ops.kernels import lstm
    for rows in (1, 64, 2048):
        want = 2 * max(lstm.bound(rows, 1024, 1024).values())
        assert counts.lstm_s(DNS64, rows, 375) * 1e3 == pytest.approx(375 * want, rel=1e-12)
    assert counts.lstm_s(DNS64, 2048, 375) == pytest.approx(0.02606, abs=1e-5)


def test_rowmm_counts_are_rowmms_bound():
    from koala_tpu_torch.ops.kernels import rowmm
    m = 2048 * 375
    want = sum(max(rowmm.bound(m * r, k, n).values())
               for r, k, n in counts.conv_products(DNS64) + counts.resample_products(DNS64))
    assert counts.rowmm_s(DNS64, m) * 1e3 == pytest.approx(want, rel=1e-12)
    # the convolutions' MACs a stream-hop: the encoder's 27.39M and the decoder's
    macs = [r * k * n for r, k, n in counts.conv_products(DNS64)]
    assert sum(macs) == 2 * 27394048


# -- the reference ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("demucs") / "demucs_tiny.pv")
    write_pv(path, {"empty": np.zeros((1,), np.float32)}, TINY)
    return path


def test_reference_matches_the_cpu_route(tiny_model):
    """The port's CPU route (the kernels' plain versions) against the plain
    reference, both at bf16 products, on the weights both draw from the
    file's seed: within the cell's limit (bf16 rounding flips)."""
    from koala_tpu_torch.engine.stream import load_model
    hops = _hops(3, 30)
    eng, params = load_model(tiny_model, "cpu")
    with torch.inference_mode():
        _, out = eng.sequence(params, eng.init_state((3,), "cpu"), hops)
    want = ref.Reference({"model": TINY}, tiny_model, "cpu").enhance(
        hops, {"products": "bfloat16", "resample": "float32"})
    parts = [compare.errors(o.numpy(), r.numpy()) for o, r in zip(out, want)]
    assert np.sqrt(sum(p[0] for p in parts) / sum(p[1] for p in parts)) < 6e-4
    assert float(want[:, :3].abs().max()) == 0.0 and float(want.abs().max()) > 1e-4


class _Run:
    def __init__(self, model_path):
        self.config = dict(_config(), model=TINY)
        with open(os.path.join(BENCH, "cells", CELL + ".json")) as f:
            self.limits = json.load(f)["limits"]
        self.model_path = model_path
        self.device = torch.device("cpu")


def test_control_fails_the_cells_limit(tiny_model):
    """The fp8 control in the program's place on 4 streams of 60 hops reads
    past the cell's limit; the reference itself reads 0."""
    run = _Run(tiny_model)
    items = [{"hops": h.numpy(), "out": None, "fused_hops": 0} for h in _hops(4, 60, seed=11)]
    ctrl = compare.compare(run, compare.control_items(run, items), run.config["precision"])
    assert any(ctrl[k] > v for k, v in run.limits.items()), (ctrl, run.limits)
    refs = compare.reference_outputs(compare.reference(run), items, run.config["precision"], "cpu")
    same = compare.compare(run, [dict(it, out=r) for it, r in zip(items, refs)],
                           run.config["precision"])
    assert same["err_rms"] == 0.0


# -- a tiny cell through the harness --------------------------------------------


def make_demucs_root(path):
    """The tiny root with the Demucs configuration under another name (its
    weights drawn from the seed) and its cell on the tiny traffic, which
    takes the real cell's limits and metric lists."""
    root = make_tiny_root(path)
    bench = os.path.join(root, "benchmark")
    cfg = _config()
    cfg["name"] = "demucs-tiny"
    cfg["model"] = TINY
    with open(os.path.join(bench, "configs", "demucs-tiny.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(bench, "cells", CELL + ".json"),
                os.path.join(bench, "cells", TINY_CELL + ".json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": TINY_CELL, "config": "demucs-tiny",
                              "traffic": "wash.tiny", "chips": 1, "why": "a tiny cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="module")
def demucs_root(tmp_path_factory):
    return make_demucs_root(tmp_path_factory.mktemp("bench_demucs"))


def test_tiny_cell_prints_the_line(demucs_root):
    rc, line, err = run_tiny(demucs_root, TINY_CELL, seconds=1.0)
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0, line["compared"]
    assert set(line["metrics"]) == {"batch_audio_s_per_s", "setup_s"}
    assert line["compared"]["err_rms"]["value"] < line["compared"]["err_rms"]["limit"]


def test_traced_tiny_cell_reads_the_unet_span(demucs_root):
    rc, line, err = run_tiny(demucs_root, TINY_CELL, seconds=1.0, trace=1)
    assert rc == 0 and line["correct"] is True, err
    # the launch counters count the card's kernels: none on the CPU
    assert line["metrics"]["unet_launches_per_hop.batch"]["value"] == 0.0
    assert line["metrics"]["unet_launches_per_hop.batch"]["unit"] == "launches/hop"
    # device readers give nothing without a card; the host readers read
    assert "unet_glue_pct.batch" not in line["metrics"]
    assert {"upload_host_ms.batch", "launch_host_ms.batch"} <= set(line["metrics"])


class _Trace:
    t0, t1 = 1000, 2000
    window_s = 1000e-9
    delta = {"batches": 2}
    kernels = [("void koala::(anonymous namespace)::lstm_cell_kernel<1>(LstmArgs)", 1100, 1300),
               ("rowmm_tile", 1300, 1400), ("elementwise_sigmoid", 1400, 1450),
               ("bfloat16_copy", 1450, 1500)]

    def kernel_s(self, match):
        return sum(b - a for n, a, b in self.kernels if match(n)) * 1e-9

    def busy_s(self):
        return 400e-9


def test_the_readers_read_the_kernels_and_the_spans(monkeypatch):
    """The glue's share of the busy time and the U-Net's launches a hop from
    the program's spans; neither from a program without them."""
    from benchmark.harness import load_module
    from koala_tpu_torch import profiling

    class Run:
        config = {"model": DNS64}
        counts = counts
        batch_rows, hops = 2048, 375
    records = [profiling.Span("demucs.resample", 1050, 1100, "engine.model", 1,
                              {"hops": 8, "launches": 3}),
               profiling.Span("demucs.encoder", 1100, 1200, "engine.model", 1,
                              {"hops": 8, "rows": 2048 * 2048, "launches": 10}),
               profiling.Span("demucs.lstm", 1200, 1300, "engine.model", 1,
                              {"hops": 8, "rows": 2048, "launches": 16}),
               profiling.Span("demucs.decoder", 1300, 1400, "engine.model", 1,
                              {"hops": 8, "rows": 2048 * 2048, "launches": 10}),
               profiling.Span("demucs.resample", 1400, 1450, "engine.model", 1,
                              {"hops": 8, "launches": 2})]
    monkeypatch.setattr(profiling, "_records", records)
    read = {}
    for name in ("unet_launches_per_hop.batch", "unet_glue_pct.batch", "lstm_roofline.batch"):
        read[name] = load_module(os.path.join(BENCH, "metrics", name + ".py"),
                                 "bench_metric_" + name.replace(".", "_")).read
    assert read["unet_launches_per_hop.batch"](Run, _Trace()) == pytest.approx(25 / 8)
    assert read["unet_glue_pct.batch"](Run, _Trace()) == pytest.approx(25.0)
    assert read["lstm_roofline.batch"](Run, _Trace()) == pytest.approx(
        100 * 2 * counts.lstm_s(DNS64, 2048, 375) / 200e-9)
    monkeypatch.setattr(profiling, "_records", [])
    assert read["unet_launches_per_hop.batch"](Run, _Trace()) is None
    assert read["unet_glue_pct.batch"](Run, _Trace()) is None
    monkeypatch.delattr(profiling, "spans")
    assert read["unet_launches_per_hop.batch"](Run, _Trace()) is None
    assert read["unet_glue_pct.batch"](Run, _Trace()) is None


# -- the faults the cell must see -------------------------------------------------


def _lstm_reset_every_8(monkeypatch):
    """The LSTM's h and c set to zeros every 8 hops of a stream."""
    from koala_tpu_torch.models import demucs
    orig = demucs._lstm

    def lstm(params, st, new, e, count, cfg):
        d = torch.empty_like(e)
        for j in range(e.shape[1]):
            if int(count.flatten()[0]) + j > 0 and (int(count.flatten()[0]) + j) % 8 == 0:
                st = dict(st, lstm_h=torch.zeros_like(st["lstm_h"]),
                          lstm_c=torch.zeros_like(st["lstm_c"]))
            d[:, j:j + 1] = orig(params, st, new, e[:, j:j + 1], count + j, cfg)
            st = dict(st, lstm_h=new["lstm_h"], lstm_c=new["lstm_c"])
        return d
    monkeypatch.setattr(demucs, "_lstm", lstm)


def _lstm_recurrence_dropped(monkeypatch):
    """The LSTM's products without their second K-segment: gates from x
    alone, W_hh h dropped (c still carried)."""
    from koala_tpu_torch.ops.kernels import lstm
    orig = lstm.lstm_cell

    def cell(x, h, c, w, b, h_out=None, c_out=None):
        return orig(x, torch.zeros_like(h), c, w, b, h_out, c_out)
    monkeypatch.setattr(lstm, "lstm_cell", cell)


def _skip_dropped(monkeypatch):
    """The skip of encoder level 2 never reaches its decoder partner."""
    from koala_tpu_torch.models import demucs
    orig = demucs._decoder

    def decoder(params, st, new, d, skips, e_last, count, cfg):
        skips = {k: torch.zeros_like(v) if k == 2 else v for k, v in skips.items()}
        return orig(params, st, new, d, skips, e_last, count, cfg)
    monkeypatch.setattr(demucs, "_decoder", decoder)


def _norm_restarted(monkeypatch):
    """The scale restarted at every hop: each hop's from that hop's mean
    square alone."""
    from koala_tpu_torch.models import demucs

    def scale(st, hops):
        ms = (hops * hops).mean(dim=-1)
        return torch.sqrt(ms), ms[:, -1]
    monkeypatch.setattr(demucs, "_scale", scale)


def _one_hop_early(monkeypatch):
    """The output one hop early: each call's hops moved one back, the
    first lost and the last a hop of zeros."""
    from koala_tpu_torch.models import demucs
    orig = demucs.apply_sequence

    def apply_sequence(params, state, hops, config=None):
        st, out = orig(params, state, hops, config)
        return st, torch.cat([out[..., 1:, :], torch.zeros_like(out[..., :1, :])], dim=-2)
    monkeypatch.setattr(demucs, "apply_sequence", apply_sequence)


@pytest.mark.parametrize("fault", [_lstm_reset_every_8, _lstm_recurrence_dropped, _skip_dropped,
                                   _norm_restarted, _one_hop_early])
def test_a_fault_is_not_correct(demucs_root, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = run_tiny(demucs_root, TINY_CELL, seconds=0.5)
    assert rc == 0, err
    assert line["correct"] is False, line["compared"]
