"""Host milliseconds of `CorpusRunner._issue`'s upload a batch: the mean of
the program's `runner.upload` spans (`koala_tpu_torch.profiling`, around
`mesh.shard_batch`) in the traced stretch. A program without the spans
gives nothing."""

from koala_tpu_torch import profiling


def read(run, trace):
    spans = getattr(profiling, "spans", None)
    d = [(s.end_ns - s.start_ns) * 1e-6 for s in (spans(trace.t0, trace.t1) if spans else ())
         if s.name == "runner.upload"]
    return sum(d) / len(d) if d else None
