"""One run of one cell: set-up, the measured window, the comparison, the line.

Everything a cell needs is found by name from `BENCHMARK.json`:

- `configs/<config>.json`: the configuration (model kind, model file or
  settings, precision, control precision);
- `traffic/<traffic>.json`: the traffic mix's parameters, whose `driver`
  names the general generator in `drivers/<driver>.py`;
- `cells/<workload>.json`: the limits of the comparison that decides
  `correct`;
- `metrics/<metric>.py`: one reader a per-layer metric (`read(run, trace)`);
- `reference/<kind>.py` and `counts/<kind>.py` (modules of this package):
  the plain reference and the operation counts of a model kind.

A run builds the program and its inputs from the seed, warms up every shape
the window uses, measures, then (with the program freed) compares a sample
of what the window produced with the plain reference, and prints one JSON
line last on standard output.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import compare
from .reference.pv import read_pv, write_pv
from .reference.stft import no_tf32
from .tracing import Window

FORBIDDEN = ("jax", "jaxlib", "flax", "koala_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = ".bench_cache"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """What a driver and a metric reader see of the run."""

    def __init__(self, root, bench_dir, workload, seed, seconds, trace, device):
        self.root = root
        self.bench_dir = bench_dir
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {c["name"]: c for c in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit("unknown workload %r (BENCHMARK.json has %s)"
                             % (workload, ", ".join(sorted(cells))))
        self.cell = cells[workload]
        self.workload = workload
        self.config = load_json(os.path.join(bench_dir, "configs", self.cell["config"] + ".json"))
        self.traffic = load_json(os.path.join(bench_dir, "traffic", self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(bench_dir, "cells", workload + ".json"))["limits"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.rng = np.random.default_rng(self.seed)
        self.cache = os.path.join(root, CACHE)
        self.counts = importlib.import_module(".counts." + self.config["kind"], __package__)
        self.model_path = self._model_file()

    def _model_file(self) -> str:
        """The model file the program loads: the configuration's, checked
        against its `model` settings, or one written from them."""
        cfg = self.config
        if cfg.get("model_file"):
            path = os.path.join(self.root, cfg["model_file"])
            _, file_cfg = read_pv(path)
            for k, v in cfg["model"].items():
                if file_cfg.get(k) != v:
                    raise RuntimeError("%s: %s is %r, the configuration says %r"
                                       % (path, k, file_cfg.get(k), v))
            return path
        path = os.path.join(self.cache, "models", cfg["name"] + ".pv")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_pv(path, {"empty": np.zeros((1,), np.float32)}, cfg["model"])
        return path


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _device_info(device) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _number(x) -> float:
    return float(x) if x is not None and math.isfinite(float(x)) else float("nan")


def measure(run, t_start: float) -> Dict:
    """Set-up, the window, and what the window produced: -> the end-to-end
    numbers, the device, attempted and failed, the window (with its trace)
    and the sample for the comparison. The program is freed before return."""
    no_tf32()
    drivers = os.path.join(run.bench_dir, "drivers", run.traffic["driver"] + ".py")
    driver = load_module(drivers, "bench_driver_" + run.traffic["driver"]).Driver(run)
    driver.setup()
    power = _power_limit() if run.device.type == "cuda" else None
    if run.trace:
        Window.warm_profiler(run.device)
    window = Window(run.seconds, run.device,
                    run.traffic.get("trace_seconds", run.seconds) if run.trace else None,
                    driver.counters)
    setup_s = time.perf_counter() - t_start
    window.start()
    driver.drive(window)
    window.finish()
    e2e = dict(driver.end_to_end(window), setup_s=setup_s)
    device_info = _device_info(run.device)
    if power is not None:
        device_info["power_limit_w"] = power
    attempted, failed = driver.attempted_failed()
    sample = driver.collect()
    driver.close()
    del driver
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"e2e": e2e, "device": device_info, "attempted": attempted, "failed": failed,
            "window": window, "sample": sample}


def per_layer(run, trace) -> Dict:
    """The cell's per-layer metrics that its readers find something to read."""
    metrics = {}
    for m in run.bench["per_layer"]:
        if run.workload not in m.get("workloads", [run.workload]):
            continue
        if m["source"] == "device_trace" and run.device.type != "cuda":
            continue        # no device: no device number
        reader = load_module(os.path.join(run.bench_dir, "metrics", m["name"] + ".py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run, trace)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def run_cell(root, workload, seed, seconds, trace, device=None, t_start=None,
             bench_dir=None, out=None, err=None) -> int:
    """One run; prints the result line; returns the exit code. `device`
    None asks for the card the cell needs, and fails without one."""
    out = out or sys.stdout
    err = err or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    if device is None:
        if not torch.cuda.is_available():
            print("benchmark: needs a CUDA card; torch.cuda.is_available() is False", file=err)
            return 2
        device = "cuda:0"
    run = Run(root, bench_dir or HERE, workload, seed, seconds, trace, device)
    chips = int(run.cell["chips"])
    if run.device.type == "cuda" and torch.cuda.device_count() < chips:
        print("benchmark: the cell needs %d cards, %d present" % (chips, torch.cuda.device_count()),
              file=err)
        return 2
    m = measure(run, t_start)
    spans = sorted((b - a) * 1e-6 for _, a, b in m["window"].spans)
    if spans:
        print("window %.3f s, %d spans, ms min %.2f median %.2f max %.2f"
              % (m["window"].elapsed, len(spans), spans[0], spans[len(spans) // 2], spans[-1]),
              file=err)
    numbers = compare.compare(run, m["sample"], run.config["precision"])
    for i, (rms, peak, loud, hop) in enumerate(numbers.get("per_stream", ())):
        print("stream %d err_rms %.4g err_peak %.4g loudest %d LSB largest difference at hop %d"
              % (i, rms, peak, loud, hop), file=err)
    compared = {k: {"value": _number(numbers.get(k)), "limit": v} for k, v in run.limits.items()}
    correct = (len(m["sample"]) > 0 and m["failed"] == 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    device_info = m["device"]
    trace_ = m["window"].trace
    if run.trace:
        device_info["busy_s"] = trace_.busy_s() if trace_ is not None else 0.0
        device_info["window_s"] = trace_.window_s if trace_ is not None else 0.0
        metrics = per_layer(run, trace_) if trace_ is not None else {}
    else:
        metrics = {e["name"]: {"value": float(m["e2e"][e["name"]]), "unit": e["unit"]}
                   for e in run.bench["end_to_end"]
                   if e["name"] in m["e2e"] and workload in e.get("workloads", [workload])}

    found = sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)
    if found:
        print("benchmark: forbidden modules loaded: %s" % ", ".join(found), file=err)
        return 3
    result = {"correct": bool(correct), "attempted": int(m["attempted"]),
              "failed": int(m["failed"]), "metrics": metrics, "device": device_info}
    if run.trace and trace_ is not None:
        result["breakdown"] = trace_.breakdown()
    result["compared"] = compared
    for k, c in compared.items():
        print("compared %s %r limit %r" % (k, c["value"], c["limit"]), file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
