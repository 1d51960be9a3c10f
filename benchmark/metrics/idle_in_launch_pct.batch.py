"""Share of the traced stretch in which the card ran no kernel and no copy
while the host was inside `CorpusRunner._issue`'s launch: the overlap of
the trace's idle gaps with the program's `runner.launch` spans, around
the engine's state and `Engine.sequence_fast` (`koala_tpu_torch.profiling`,
on the profiler's clock). A program without the spans gives nothing."""

from benchmark.tracing import union
from koala_tpu_torch import profiling


def overlap_ns(a, b):
    """The length in common of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run, trace):
    spans = getattr(profiling, "spans", None)
    if spans is None or trace.window_s <= 0:
        return None
    inside = union([(s.start_ns, s.end_ns) for s in spans(trace.t0, trace.t1)
                    if s.name == "runner.launch"], trace.t0, trace.t1)
    if not inside:
        return None
    return 100.0 * overlap_ns(trace.gaps(), inside) * 1e-9 / trace.window_s
