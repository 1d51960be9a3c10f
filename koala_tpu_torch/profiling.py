"""Observability: logging toggles, tracing, and throughput counters.

The same surface as the JAX package's ``profiling.py``:

- ``log_enable`` / ``log_disable``: the ``koala_tpu_torch`` logger on or off
  (the analog of the reference runtime's pv_log_enable / pv_log_disable).
- ``trace``: a context manager around ``torch.profiler.profile`` that writes
  a Chrome trace (``chrome://tracing``, Perfetto) into a directory.
- ``ThroughputMeter``: audio-seconds per second for serving loops.
- ``machine_state``: a host telemetry snapshot (load, memory, CPU count).

and, for the port's measurements (``chip_smoke.py``, ``scripts/``):
``time_ms`` (CUDA events, eager or queued behind a spin kernel),
``wall_ms`` (the host's clock), and ``bound``: the least time of some work
on an H100 SXM, by bytes and by operations, from the card's published
peaks (``HBM_BYTES_PER_S``, ``BF16_TENSOR_FLOPS``, ``F32_FLOPS``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from .constants import FRAME_LENGTH, SAMPLE_RATE

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
    shapes and types in the trace. Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "koala_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, record_shapes=record_shapes) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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


class ThroughputMeter:
    """Rolling audio-throughput counter for serving loops."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()
        self._frames = 0
        self._device_steps = 0

    def add_frames(self, n: int) -> None:
        self._frames += n
        self._device_steps += 1

    @property
    def report(self) -> Dict[str, float]:
        elapsed = max(time.perf_counter() - self._start, 1e-9)
        audio_s = self._frames * FRAME_LENGTH / SAMPLE_RATE
        return {
            "elapsed_s": elapsed,
            "frames": self._frames,
            "device_steps": self._device_steps,
            "audio_seconds": audio_s,
            "audio_seconds_per_second": audio_s / elapsed,
            "frames_per_step": self._frames / max(self._device_steps, 1),
        }


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


__all__ = ["log_enable", "log_disable", "trace", "ThroughputMeter",
           "machine_state", "logger", "TRACE_FILE", "bound", "time_ms", "wall_ms",
           "HBM_BYTES_PER_S", "BF16_TENSOR_FLOPS", "F32_FLOPS"]
