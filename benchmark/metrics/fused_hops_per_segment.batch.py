"""Hops the fused entry (`csrc/engine_fused.cu`) walks a segment of its
fixed workspace: the sum of the `hops` counts of the program's
`engine.fused` spans (`koala_tpu_torch.profiling`) in the traced stretch
over the sum of their `segments`. A program without the spans gives
nothing."""

from koala_tpu_torch import profiling


def read(run, trace):
    spans = getattr(profiling, "spans", None)
    fused = [s.counts for s in (spans(trace.t0, trace.t1) if spans else ())
             if s.name == "engine.fused"]
    segments = sum(c["segments"] for c in fused)
    return sum(c["hops"] for c in fused) / segments if segments else None
