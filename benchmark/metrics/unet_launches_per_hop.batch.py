"""`rowmm` and LSTM launches a hop of Demucs's U-Net outside its LSTM: the
`launches` of the program's `demucs.encoder`, `demucs.decoder` and
`demucs.resample` spans (`koala_tpu_torch.profiling`) in the traced stretch
over the hops the blocks walked (the `hops` of the `demucs.encoder` spans,
one a block). It falls as more hops are blocked together. A program
without the spans gives nothing."""

from koala_tpu_torch import profiling

NAMES = ("demucs.encoder", "demucs.decoder", "demucs.resample")


def read(run, trace):
    spans = getattr(profiling, "spans", None)
    found = [s for s in (spans(trace.t0, trace.t1) if spans else ()) if s.name in NAMES]
    hops = sum(s.counts.get("hops", 0) for s in found if s.name == "demucs.encoder")
    if not hops:
        return None
    return sum(s.counts.get("launches", 0) for s in found) / hops
