"""Host milliseconds of `CorpusRunner._issue`'s launch a batch: the mean of
the program's `runner.launch` spans (`koala_tpu_torch.profiling`, around
the engine's state and `Engine.sequence_fast`) in the traced stretch. A
program without the spans gives nothing."""

from koala_tpu_torch import profiling


def read(run, trace):
    spans = getattr(profiling, "spans", None)
    d = [(s.end_ns - s.start_ns) * 1e-6 for s in (spans(trace.t0, trace.t1) if spans else ())
         if s.name == "runner.launch"]
    return sum(d) / len(d) if d else None
