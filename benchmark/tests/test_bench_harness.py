"""The harness on the CPU: tiny cells print the contract's line, new cells,
mixes, configurations and metrics are found as new files, and a run whose
timed path is broken underneath comes out not correct."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import CELLS, make_tiny_root, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_prints_the_line(tiny_root, cell, trace):
    rc, line, err = run_tiny(tiny_root, cell, trace=trace)
    assert rc == 0, err
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["compared"]) == {"err_rms"}
    assert err.strip().splitlines()[-1].startswith("compared ")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    if trace:
        assert {"busy_s", "window_s", "platform", "kind", "count",
                "memory_peak_bytes"} <= set(line["device"])
        assert "breakdown" in line
        want = {m["name"] for m in spec["per_layer"] if cell in m["workloads"]
                and m["source"] != "device_trace"}      # no device here: no device numbers
    else:
        want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
        assert "setup_s" in want
    assert set(line["metrics"]) == want
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and np.isfinite(v["value"])


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p and not os.path.islink(d):
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files, with no file that exists edited but BENCHMARK.json."""
    root = make_tiny_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    before = _digest(bench)
    with open(os.path.join(bench, "configs", "mmse.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "mmse-floor10"
    cfg["model"]["gain_floor"] = 0.1
    with open(os.path.join(bench, "configs", "mmse-floor10.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "wash.tiny.json")) as f:
        mix = dict(json.load(f), global_batch=2, utterance_seconds=0.5)
    with open(os.path.join(bench, "traffic", "wash.drop.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "cells", "mmse-floor10.wash.drop.json"), "w") as f:
        json.dump({"limits": {"err_rms": 1e-5}}, f)
    with open(os.path.join(bench, "metrics", "batches_traced.batch.py"), "w") as f:
        f.write("def read(run, trace):\n    return trace.delta['batches']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = "mmse-floor10.wash.drop"
    spec["workloads"].append({"name": cell, "config": "mmse-floor10", "traffic": "wash.drop",
                              "chips": 1, "why": "dropped in"})
    spec["per_layer"].append({"name": "batches_traced.batch", "unit": "batches",
                              "better": "higher", "source": "program_counter",
                              "layer": "parallel/runner.py", "moves": "batch_audio_s_per_s",
                              "workloads": [cell]})
    next(m for m in spec["end_to_end"] if m["name"] == "batch_audio_s_per_s")[
        "workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    after = _digest(bench)
    assert all(after[k] == v for k, v in before.items())
    rc, line, err = run_tiny(root, cell, trace=1)
    assert rc == 0 and line["correct"] is True, err
    assert line["metrics"]["batches_traced.batch"]["value"] >= 1
    rc, line, err = run_tiny(root, cell, trace=0)
    assert set(line["metrics"]) == {"batch_audio_s_per_s", "setup_s"}


# -- the timed path broken underneath ---------------------------------------


def _state_unchanged(monkeypatch):
    """Every recurrence returns its state as it came in."""
    from koala_tpu_torch.models import mask_gru
    monkeypatch.setattr(mask_gru, "_gru_recurrent", lambda params, i, h, xproj, cfg: h)


def _half_batch(monkeypatch):
    """The second half of every batch left out: its rows come back as zeros."""
    from koala_tpu_torch.parallel.runner import CorpusRunner
    orig = CorpusRunner.enhance_batch

    def half(self, pcm):
        out = orig(self, pcm).clone()
        out[out.shape[0] // 2:] = 0.0
        return out
    monkeypatch.setattr(CorpusRunner, "enhance_batch", half)


def _answer_altered(monkeypatch):
    """One hop of every stream's output altered where the engine makes it."""
    from koala_tpu_torch.engine import core
    orig = core.Engine.sequence

    def altered(self, params, state, hops):
        st, out = orig(self, params, state, hops)
        out = out.clone()
        out[..., out.shape[-2] // 2, :] *= 1.5
        return st, out
    monkeypatch.setattr(core.Engine, "sequence", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
FAULT_CELLS = [("koala-gru384x2.wash.tiny", "state_unchanged"),
               ("koala-gru384x2.wash.tiny", "half_batch"),
               ("mmse.wash.tiny", "half_batch"),
               ("mmse.wash.tiny", "answer_altered"),
               ("koala-gru384x2.wash.tiny", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULT_CELLS)
def test_a_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    rc, line, err = run_tiny(tiny_root, cell, seconds=1.0)
    assert rc == 0, err
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("cell", ["koala-gru384x2.wash.tiny", "mmse.wash.tiny"])
def test_the_control_in_the_programs_place_is_not_correct(tiny_root, monkeypatch, cell):
    """The reference at the control precision in the program's place."""
    from benchmark import compare
    from koala_tpu_torch.parallel.runner import CorpusRunner
    runs = []
    orig_compare = compare.compare

    def control_compare(run, items, precision):
        runs.append(run)
        return orig_compare(run, compare.control_items(run, items), precision)
    monkeypatch.setattr(compare, "compare", control_compare)
    monkeypatch.setattr(CorpusRunner, "enhance_batch", lambda self, pcm: torch.as_tensor(
        np.asarray(pcm, np.float32)).reshape(self.global_batch, self.frames, 256))
    rc, line, err = run_tiny(tiny_root, cell, seconds=0.5)
    assert rc == 0 and runs, err
    assert line["correct"] is False, line["compared"]
