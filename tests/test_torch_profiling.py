"""The port's observability module (koala_tpu_torch/profiling.py): the
analogs of tests/test_profiling.py, and a trace of a CPU sequence call."""

import json
import os
import time

import numpy as np
import torch

from koala_tpu_torch import profiling
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models import mmse

import torch_ref  # noqa: F401  (pins torch to 2 threads)


def test_log_toggle(capsys):
    profiling.log_enable()
    profiling.logger.info("hello from koala")
    profiling.log_disable()
    profiling.logger.info("you should not see this")
    err = capsys.readouterr().err
    assert "hello from koala" in err
    assert "should not see this" not in err


def test_throughput_meter():
    m = profiling.ThroughputMeter()
    m.add_frames(256)
    m.add_frames(256)
    r = m.report
    assert r["frames"] == 512
    assert r["device_steps"] == 2
    assert abs(r["audio_seconds"] - 512 * 256 / 16000) < 1e-9
    assert r["audio_seconds_per_second"] > 0


def test_machine_state():
    state = profiling.machine_state()
    assert "time" in state
    assert state.get("cpu_count", 1) >= 1


def test_trace_writes_a_trace_of_a_cpu_sequence_call(tmp_path):
    engine = make_engine("mmse", mmse.DEFAULT_CONFIG)
    hops = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 4, 256))
                           .astype(np.float32) * 0.1)
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        _, out = engine.sequence(mmse.init_params(), engine.init_state((2,), "cpu"), hops)
    assert out.shape == (2, 4, 256)
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    # the STFT's products ran inside the traced region
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_kernel_bounds_keep_their_values():
    """The bounds that chip_smoke.py and scripts/bench_sweep_torch.py share
    (each kernel module's ``bound``, over ``profiling.bound``): the floor
    kernel at the serving path's lb [376, 64, 32], the GRU stack at x
    [376, 64, 384] x 2 layers, the fused entry at the bench's hops
    [512, 376, 256] on the bundled model."""
    from koala_tpu_torch.engine.stream import load_model
    from koala_tpu_torch.models.params_io import default_model_path
    from koala_tpu_torch.ops.kernels import engine_fused, floor, gru

    fl = floor.bound(376, 64, 32)
    assert max(fl, key=fl.get) == "bytes" and round(fl["bytes"] * 1e3, 2) == 1.84   # us
    g = gru.bound(376, 64, 384, 2, hidden_out=False)
    assert max(g, key=g.get) == "operations" and round(g["operations"], 4) == 0.0861
    hs = gru.bound(63, 64, 384, 2, hidden_out=True)
    assert round(max(hs.values()), 4) == 0.0144
    engine, params = load_model(default_model_path(), "cpu")
    f = engine_fused.bound(params, engine.config, 512, 376)
    assert max(f, key=f.get) == "operations" and round(f["operations"], 3) == 1.001
    f64 = engine_fused.bound(params, engine.config, 64, 376)
    assert round(f64["operations"], 4) == 0.1251


def test_wall_ms_counts_the_timed_calls_after_the_warmup():
    """The host-clock timer that scripts/bench_sweep_torch.py uses off the
    card: ``warmup`` untimed calls, then the mean of ``reps`` timed ones."""
    calls = []

    def fn():
        calls.append(time.perf_counter())
        time.sleep(0.002)

    ms = profiling.wall_ms(fn, 3, warmup=2, device=torch.device("cpu"))
    assert len(calls) == 5 and ms >= 2.0
