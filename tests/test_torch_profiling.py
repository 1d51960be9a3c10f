"""The port's observability module (koala_tpu_torch/profiling.py): the
analogs of tests/test_profiling.py, a trace of a CPU sequence call, and the
program's spans (recorded only under a profiler, on the profiler's clock)."""

import collections
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


CPU = [torch.profiler.ProfilerActivity.CPU]


def test_no_span_is_recorded_without_a_profiler():
    assert not profiling.recording()
    t0 = time.time_ns()
    with profiling.span("test.off", hops=3) as s:
        assert s is None
    assert profiling.spans(t0) == []


def test_nested_spans_carry_parent_batch_and_counts():
    t0 = time.time_ns()
    with torch.profiler.profile(activities=CPU):
        assert profiling.recording()
        with profiling.span("test.outer", batch=7):
            with profiling.span("test.inner", hops=5, segments=2):
                pass
            with profiling.span("test.second"):
                pass
    got = {s.name: s for s in profiling.spans(t0, time.time_ns())}
    outer, inner, second = got["test.outer"], got["test.inner"], got["test.second"]
    assert outer.parent is None and outer.batch == 7 and outer.counts == {}
    assert inner.parent == second.parent == "test.outer"
    assert inner.batch == second.batch == 7
    assert inner.counts == {"hops": 5, "segments": 2}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns
    assert [s.name for s in profiling.spans(t0, time.time_ns())] == [
        "test.outer", "test.inner", "test.second"]
    # a stretch that ends before the outer span does keeps only what lies in it
    assert "test.outer" not in {s.name for s in profiling.spans(t0, outer.end_ns - 1)}


def test_spans_share_the_profilers_clock():
    """A span around an operator contains that operator's interval as the
    profiler's own events give it."""
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("test.add"):
            torch.ones(1000) + 1
    s = next(s for s in profiling.spans() if s.name == "test.add")
    adds = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add"]
    assert len(adds) == 1
    start = adds[0].start_ns()
    assert s.start_ns <= start <= start + adds[0].duration_ns() <= s.end_ns


def test_trace_writes_the_spans_on_their_own_track(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        with profiling.span("test.traced", batch=3, hops=4):
            torch.ones(1000) + 1
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    mine = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in mine] == ["test.traced"]
    add = next(e for e in events if e.get("name") == "aten::add")
    span = mine[0]
    assert span["args"] == {"hops": 4, "parent": None, "batch": 3}
    # the same time base as the profiler's events: the span holds the operator
    assert span["ts"] <= add["ts"] and add["ts"] + add["dur"] <= span["ts"] + span["dur"]
    assert span["pid"] not in {e.get("pid") for e in events if e.get("cat") != "span"
                               and e.get("ph") != "M"}
    track = [e for e in events if e.get("ph") == "M" and e.get("pid") == span["pid"]]
    assert track and track[0]["args"]["name"] == profiling.SPAN_TRACK


def test_span_buffer_drops_its_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=4))
    dropped = profiling.spans_dropped
    with torch.profiler.profile(activities=CPU):
        for i in range(6):
            with profiling.span("test.ring", i=i):
                pass
    assert [s.counts["i"] for s in profiling.spans()] == [2, 3, 4, 5]
    assert profiling.spans_dropped == dropped + 2


def test_spans_from_many_threads_are_all_kept_or_counted(monkeypatch):
    """Threads (more than cores) close spans into a small buffer at once,
    the interpreter switching threads often: every span is kept or counted
    as dropped, and each keeps its own thread's parent. (A profiler's state
    is the thread's own, so the recorder's check is patched on here.)"""
    import sys
    import threading

    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=64))
    monkeypatch.setattr(profiling, "recording", lambda: True)
    dropped = profiling.spans_dropped
    workers, each = 2 * (os.cpu_count() or 1) + 2, 200

    def work(i):
        for _ in range(each):
            with profiling.span("test.thread", batch=i):
                with profiling.span("test.leaf"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    kept = profiling.spans()
    assert len(kept) == 64
    assert len(kept) + profiling.spans_dropped - dropped == workers * each * 2
    assert all(s.parent == "test.thread" for s in kept if s.name == "test.leaf")


def test_fused_plain_version_records_one_segment():
    """On the CPU the fused entry runs its plain version: one ``engine.fused``
    span of the call's hops in one segment."""
    from koala_tpu_torch.engine.stream import load_model
    from koala_tpu_torch.models.params_io import default_model_path
    from koala_tpu_torch.ops.kernels.engine_fused import fused_sequence

    engine, params = load_model(default_model_path(), "cpu")
    hops = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 8, 256))
                           .astype(np.float32) * 0.1)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=CPU):
        fused_sequence(params, engine.init_state((2,), "cpu"), hops, engine.config)
    (s,) = [s for s in profiling.spans(t0) if s.name == "engine.fused"]
    assert s.counts == {"hops": 8, "segments": 1}
