"""Tiny cells of the benchmark on the CPU, made from the real files.

`tiny_root` builds a checkout-like directory: `BENCHMARK.json` with the real
cells plus tiny ones that reuse their configurations and limits, a copy of
the benchmark's data folder with the tiny traffic mixes added, and links to
the repository's model and audio. `run_tiny` runs one cell there through
the harness on the CPU (the harness's look for a card skipped) and returns
its exit code, its result line and its standard error.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {
    "wash.tiny": ("wash.b16384", {"global_batch": 4, "utterance_seconds": 1.0,
                                  "distinct_batches": 2, "sample": 8, "trace_seconds": 0.5}),
}
CELLS = {  # tiny cell -> (configuration, tiny mix, the real cell whose limits it takes)
    "koala-gru384x2.wash.tiny": ("koala-gru384x2", "wash.tiny", "koala-gru384x2.wash.b16384"),
    "mmse.wash.tiny": ("mmse", "wash.tiny", "mmse.wash.b8192.pinned"),
}


def make_tiny_root(path):
    root = str(path)
    bench = os.path.join(root, "benchmark")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("models", os.path.join("resources", "audio_samples")):
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        os.symlink(os.path.join(REPO, name), os.path.join(root, name))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for mix, (base, changes) in TINY.items():
        with open(os.path.join(bench, "traffic", base + ".json")) as f:
            tr = dict(json.load(f), **changes)
        with open(os.path.join(bench, "traffic", mix + ".json"), "w") as f:
            json.dump(tr, f)
    for cell, (config, mix, real) in CELLS.items():
        spec["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                                  "why": "a tiny cell for the CPU tests"})
        shutil.copy(os.path.join(bench, "cells", real + ".json"),
                    os.path.join(bench, "cells", cell + ".json"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


def run_tiny(root, cell, seed=2 ** 31 + 7, seconds=1.5, trace=0):
    from benchmark.harness import run_cell
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(root, cell, seed, seconds, trace, device="cpu",
                  bench_dir=os.path.join(root, "benchmark"), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def cuda():
    """For tests that need the card: skip without one (decided here, not
    when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
