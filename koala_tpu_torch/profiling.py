"""Observability: logging toggles, tracing, and throughput counters.

The same surface as the JAX package's ``profiling.py``:

- ``log_enable`` / ``log_disable``: the ``koala_tpu_torch`` logger on or off
  (the analog of the reference runtime's pv_log_enable / pv_log_disable).
- ``trace``: a context manager around ``torch.profiler.profile`` that writes
  a Chrome trace (``chrome://tracing``, Perfetto) into a directory.
- ``ThroughputMeter``: audio-seconds per second for serving loops.
- ``machine_state``: a host telemetry snapshot (load, memory, CPU count).
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
def trace(log_dir: Optional[str] = None):
    """Profile a code region and write ``<log_dir>/trace.json``::

        with profiling.trace("traces"):
            engine.sequence(params, state, hops)

    CPU activity is always recorded; CUDA activity (the card's kernels and
    copies) when a card is present. ``log_dir`` defaults to a directory under
    the temporary directory. Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "koala_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
           "machine_state", "logger", "TRACE_FILE"]
