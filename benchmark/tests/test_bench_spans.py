"""The readers of the program's own spans: a traced tiny cell reports the two
host-clock metrics, and the two idle readers put a hand-built trace's gaps
down to the spans that overlap them."""

import os

import pytest
import torch

from conftest import BENCH, CELLS, run_tiny


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_tiny_cell_reads_the_program_spans(tiny_root, cell):
    rc, line, err = run_tiny(tiny_root, cell, trace=1)
    assert rc == 0 and line["correct"] is True, err
    # the program's own spans, read on the profiler's clock
    assert {"upload_host_ms.batch", "launch_host_ms.batch"} <= set(line["metrics"])
    for name in ("upload_host_ms.batch", "launch_host_ms.batch"):
        assert line["metrics"][name]["unit"] == "ms" and line["metrics"][name]["value"] > 0


class _Event:
    """A profiler event of the card, as `Trace` reads one."""

    def __init__(self, name, start, end):
        self._name, self._start, self._end = name, start, end

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return torch.autograd.DeviceType.CUDA


def test_idle_readers_put_the_gaps_down_to_the_spans(monkeypatch):
    """A stretch of 1000 ns with a kernel at [100, 200), a copy at [400, 500)
    and a kernel at [800, 900): its gaps [0, 100), [200, 400), [500, 800) and
    [900, 1000) overlap the upload span [150, 450) for 200 ns and the launch
    span [450, 950) for 350 ns; a span that leaves the stretch is not read,
    and a program without spans gives nothing."""
    from benchmark.harness import load_module
    from benchmark.tracing import Trace
    from koala_tpu_torch import profiling

    trace = Trace(1000, 2000, [_Event("k", 1100, 1200), _Event("Memcpy HtoD", 1400, 1500),
                               _Event("k", 1800, 1900)], [], {}, {})
    assert trace.gaps() == [(1000, 1100), (1200, 1400), (1500, 1800), (1900, 2000)]
    records = [profiling.Span("runner.upload", 1150, 1450, "runner.issue", 1, {}),
               profiling.Span("runner.launch", 1450, 1950, "runner.issue", 1, {}),
               profiling.Span("runner.launch", 1950, 2050, "runner.issue", 2, {})]
    monkeypatch.setattr(profiling, "_records", records)
    read = {}
    for what in ("upload", "launch"):
        name = "idle_in_%s_pct.batch" % what
        read[what] = load_module(os.path.join(BENCH, "metrics", name + ".py"), name).read
    assert read["upload"](None, trace) == pytest.approx(20.0)
    assert read["launch"](None, trace) == pytest.approx(35.0)
    monkeypatch.delattr(profiling, "spans")
    assert read["upload"](None, trace) is None and read["launch"](None, trace) is None
