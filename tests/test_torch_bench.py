"""bench_torch.py, the port's counterpart of bench.py, on the CPU at a tiny
size: its one JSON line carries every key of bench.py's record, it refuses
to run without a card unless the CPU is asked for, a failed phase stops it,
and its chain of steps is n calls of Engine.step."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ref  # noqa: F401  (pins torch to 2 threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "bench_torch.py")
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

TINY = {"KOALA_BENCH_BATCH": "4", "KOALA_BENCH_FRAMES": "16", "KOALA_BENCH_ITERS": "2",
        "KOALA_BENCH_SERVE_STREAMS": "4", "KOALA_BENCH_SERVE_SECS": "0.5",
        "KOALA_BENCH_SERVE_CHUNK": "8"}

# Every key of bench.py's record (bench.py:392-403, serving_bench :127-139,
# transport_calibration :211-217, main :414-418, single_stream_latency :321-327).
BENCH_PY_KEYS = [
    "metric", "value", "unit", "vs_baseline", "batch", "chunk_frames", "iters", "wall_s",
    "model", "device",
    "serving_streams", "serving_chunk_frames", "serving_audio_s_per_s_per_chip",
    "serving_vs_baseline", "serving_producer_audio_s_per_s", "serving_rounds_per_s",
    "serving_frames_per_round", "serving_p50_ms", "serving_p99_ms",
    "serving_p50_ms_occ25", "serving_p99_ms_occ25", "serving_p50_ms_occ50",
    "serving_p99_ms_occ50", "serving_p50_ms_occ100", "serving_p99_ms_occ100",
    "wire_up_mbps", "wire_down_mbps", "wire_rtt_ms", "wire_ceiling_serial_audio_s",
    "wire_ceiling_duplex_audio_s", "serving_frac_of_wire_serial",
    "serving_frac_of_wire_duplex",
    "step_p50_ms", "step_p99_ms", "step_device_p50_ms", "step_device_amortized_ms",
    "step_budget_ms",
]


def _run(*args, env=None):
    env = dict(os.environ, OMP_NUM_THREADS="2", **(env or {}))
    return subprocess.run([sys.executable, SCRIPT, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cpu_record_has_every_key_of_bench_py():
    r = _run("--device", "cpu", env=TINY)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    record = json.loads(lines[0])
    missing = [k for k in BENCH_PY_KEYS if k not in record]
    assert not missing, missing
    assert not [k for k in record if k.endswith("_error")]
    assert record["device"] == "cpu" and record["power_limit_w"] is None
    assert record["segments"] == 0                 # the CPU takes no fused entry
    assert (record["batch"], record["chunk_frames"], record["iters"]) == (4, 16, 2)
    assert record["serving_streams"] == 4 and record["serving_chunk_frames"] == 8
    for k in BENCH_PY_KEYS:
        if k not in ("metric", "unit", "model", "device"):
            assert np.isfinite(record[k]) and record[k] >= 0, (k, record[k])


def test_without_a_card_it_stops_unless_the_cpu_is_asked():
    r = _run(env=dict(TINY, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "KoalaInvalidArgumentError" in r.stderr and not r.stdout.strip()


def test_a_failed_phase_stops_the_run(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("serving failed")
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("KOALA_BENCH_LATENCY", "0")
    monkeypatch.setattr(bench_torch, "serving_bench", broken)
    with pytest.raises(RuntimeError, match="serving failed"):
        bench_torch.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_step_chain_is_n_engine_steps():
    """The chain's eager form (the CPU's; a card replays the same step as a
    CUDA graph): n chained steps leave the state and frame that n calls of
    Engine.step leave, bit for bit."""
    dev = torch.device("cpu")
    engine, params = bench_torch.load_engine(dev)
    hop = torch.as_tensor(np.random.default_rng(9).standard_normal(256).astype(np.float32)
                          * 0.05)
    with torch.inference_mode():
        chain = bench_torch.StepChain(engine, params, engine.init_state((), dev), hop.clone())
        chain.run(7)
        state, out = engine.init_state((), dev), hop
        for _ in range(7):
            state, out = engine.step(params, state, out)
    assert torch.equal(chain.hop, out)
    for k in ("input_carry", "ola"):
        assert torch.equal(chain.state[k], state[k])
    for k in ("h", "floor"):
        assert torch.equal(chain.state["model"][k], state["model"][k])
