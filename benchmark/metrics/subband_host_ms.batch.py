"""Host milliseconds of one frame of FullSubNet's sub-band model: the mean
of the program's `fullsubnet.subband` spans (`koala_tpu_torch.profiling`,
around a frame's unfold, normalisation, LSTM launches and output layer) in
the traced stretch. A program without the span gives nothing."""

from koala_tpu_torch import profiling


def read(run, trace):
    spans = getattr(profiling, "spans", None)
    d = [(s.end_ns - s.start_ns) * 1e-6 for s in (spans(trace.t0, trace.t1) if spans else ())
         if s.name == "fullsubnet.subband"]
    return sum(d) / len(d) if d else None
