"""The port's observability module (koala_tpu_torch/profiling.py): the
analogs of tests/test_profiling.py, and a trace of a CPU sequence call."""

import json
import os

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
