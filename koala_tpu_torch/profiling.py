"""Observability: logging toggles, tracing, and the program's spans.

The JAX package's ``profiling.py`` surface, less its throughput meter:

- ``log_enable`` / ``log_disable``: the ``koala_tpu_torch`` logger on or off
  (the analog of the reference runtime's pv_log_enable / pv_log_disable).
- ``trace``: a context manager around ``torch.profiler.profile`` that writes
  a Chrome trace (``chrome://tracing``, Perfetto) into a directory, the
  program's spans on a track of their own.
- ``machine_state``: a host telemetry snapshot (load, memory, CPU count).

The program's spans: ``span(name, **counts)`` marks a region of host time
at a layer boundary (the corpus runner's upload and launch, the fused
entry's segment walk, the unfused sequence and its model), on the clock of
the profiler's events (``time.time_ns``). A span is recorded only while a
torch profiler runs on the calling thread (``recording``; the profiler's own
scope), so an unprofiled call pays one check; ``counted_span`` adds the
kernel launches made inside as a count; ``spans(t0_ns, t1_ns)`` reads the
records kept.

and, for the port's measurements (``chip_smoke.py``, ``scripts/``):
``time_ms`` (CUDA events, eager or queued behind a spin kernel),
``wall_ms`` (the host's clock), and ``bound``: the least time of some work
on an H100 SXM, by bytes and by operations, from the card's published
peaks (``HBM_BYTES_PER_S``, ``BF16_TENSOR_FLOPS``, ``F32_FLOPS``).
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

logger = logging.getLogger("koala_tpu_torch")
logger.addHandler(logging.NullHandler())

TRACE_FILE = "trace.json"


def log_enable(level: int = logging.INFO) -> None:
    """Enable the package's logging on stderr."""
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "[koala_tpu_torch %(levelname)s %(asctime)s] %(message)s"))
    logger.handlers = [h for h in logger.handlers
                       if isinstance(h, logging.NullHandler)]
    logger.addHandler(handler)
    logger.setLevel(level)


def log_disable() -> None:
    """Disable the package's logging."""
    logger.handlers = [logging.NullHandler()]
    logger.setLevel(logging.CRITICAL + 1)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, record_shapes: bool = False):
    """Profile a code region and write ``<log_dir>/trace.json``::

        with profiling.trace("traces"):
            engine.sequence(params, state, hops)

    CPU activity is always recorded; CUDA activity (the card's kernels and
    copies) when a card is present. ``log_dir`` defaults to a directory under
    the temporary directory. ``record_shapes`` keeps each operator's input
    shapes and types in the trace. The program's spans recorded meanwhile
    (``spans``) go into the file on a track of their own. Yields
    ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "koala_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities, record_shapes=record_shapes) as prof:
        yield log_dir
    t1 = time.time_ns()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _write_spans(path, spans(t0, t1))


# -- the program's spans -----------------------------------------------------

class Span(NamedTuple):
    """One recorded span: ``parent`` is the name of the span open on the
    same thread when it started; ``batch`` the request it belongs to (the
    corpus runner's batch number, inherited from the parent); ``counts``
    integers recorded where the work is done."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    batch: Optional[int]
    counts: Dict[str, int]


SPAN_CAPACITY = 65536
SPAN_TRACK = "koala_tpu_torch spans"
_records: "collections.deque[Span]" = collections.deque(maxlen=SPAN_CAPACITY)
# records the bounded buffer let go, the oldest first
spans_dropped = 0
_records_lock = threading.Lock()     # spans close on the server's threads too


class _Open(threading.local):
    """The spans open on each thread, innermost last."""

    def __init__(self):
        self.stack: List["_Span"] = []


_open = _Open()
_OFF = contextlib.nullcontext()

# Whether spans are recorded: true while a torch profiler (``trace``, the
# benchmark's traced stretch, an operator's own ``torch.profiler.profile``)
# runs on the calling thread, the threads whose operators it records.
recording = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "batch", "counts", "parent", "start")

    def __init__(self, name: str, batch: Optional[int], counts: Dict[str, int]):
        self.name, self.batch, self.counts = name, batch, counts

    def __enter__(self):
        stack = _open.stack
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.batch is None and outer is not None:
            self.batch = outer.batch
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global spans_dropped
        end = time.time_ns()
        _open.stack.pop()
        record = Span(self.name, self.start, end, self.parent, self.batch, self.counts)
        with _records_lock:
            if len(_records) == _records.maxlen:
                spans_dropped += 1
            _records.append(record)
        return False


def span(name: str, batch: Optional[int] = None, **counts: int):
    """A context manager that records the host time of a region as a
    ``Span`` while a profiler runs (``recording``); otherwise it does
    nothing. ``counts``: integers of the work done inside (hops, bytes).
    Not built on ``record_function``: it adds no event to the profiler's
    own, on the host or on the card."""
    if not recording():
        return _OFF
    return _Span(name, batch, counts)


@contextlib.contextmanager
def counted_span(name: str, launched: Callable[[], int], key: str = "launches", **counts: int):
    """``span`` whose count ``key`` is filled in on exit: how far
    ``launched()`` (the sum of some kernels' launch counters) rose inside."""
    before = launched()
    with span(name, **counts) as s:
        yield s
        if s is not None:
            s.counts[key] = launched() - before


def spans(t0_ns: int = 0, t1_ns: Optional[int] = None) -> List[Span]:
    """The kept spans that start and end inside [t0_ns, t1_ns], by start."""
    hi = time.time_ns() if t1_ns is None else t1_ns
    with _records_lock:
        kept = list(_records)
    return sorted((s for s in kept if s.start_ns >= t0_ns and s.end_ns <= hi),
                  key=lambda s: s.start_ns)


def _write_spans(path: str, records: List[Span]) -> None:
    """Add ``records`` to the Chrome trace at ``path`` as complete events on
    a track of their own, on the file's time base (microseconds from its
    ``baseTimeNanoseconds``)."""
    if not records:
        return
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = max([e["pid"] for e in events if isinstance(e.get("pid"), int)] + [0]) + 1
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": SPAN_TRACK}})
    for s in records:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.counts, parent=s.parent, batch=s.batch)})
    with open(path, "w") as f:
        json.dump(doc, f)


# Published peaks of one H100 SXM (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12


def bound(n_bytes: float, bf16_ops: float, f32_ops: float) -> Dict[str, float]:
    """Least time (ms) of some work on the card, {"bytes": ms, "operations":
    ms}: the bytes over the memory rate, and the slower of the bf16 products
    on the tensor cores and the f32 work on the CUDA cores (the two run side
    by side). The bound is the larger. Each kernel module counts its own
    work (``floor.bound``, ``gru.bound``, ``engine_fused.bound``)."""
    return {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
            "operations": max(bf16_ops / BF16_TENSOR_FLOPS, f32_ops / F32_FLOPS) * 1e3}


def time_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after warm-up).
    ``queued``: the calls are made while the card is busy with a spin kernel
    of about 20 ms, so they wait in the stream and run back to back. That is
    the card's time for a kernel of a few microseconds, which the host cannot
    launch as fast as the card runs it: without it the events time the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int, warmup: int = 1, device: Optional[torch.device] = None) -> float:
    """Mean milliseconds of ``fn`` by the host's clock, after warm-up. With a
    CUDA ``device`` the card is synchronised before the clock starts and
    after the last call, so its queued work is inside the time."""
    sync = device is not None and device.type == "cuda"
    for _ in range(warmup):
        fn()
    if sync:
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    if sync:
        torch.cuda.synchronize(device)
    return (time.perf_counter() - start) / reps * 1e3


def machine_state() -> Dict[str, object]:
    """Host telemetry snapshot (load average, memory, CPU count) to keep
    beside a measurement."""
    state: Dict[str, object] = {"time": time.time()}
    try:
        state["loadavg"] = os.getloadavg()
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as f:
            mem = {}
            for line in f:
                parts = line.split(":")
                if parts[0] in ("MemTotal", "MemAvailable", "SwapTotal", "SwapFree"):
                    mem[parts[0]] = parts[1].strip()
            state["meminfo"] = mem
    except OSError:
        pass
    state["cpu_count"] = os.cpu_count()
    return state


__all__ = ["log_enable", "log_disable", "trace", "machine_state", "logger", "TRACE_FILE",
           "Span", "span", "spans", "recording", "SPAN_CAPACITY", "SPAN_TRACK", "bound",
           "time_ms", "wall_ms", "HBM_BYTES_PER_S", "BF16_TENSOR_FLOPS", "F32_FLOPS"]
