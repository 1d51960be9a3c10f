"""Share of the card's busy time in the traced stretch that Demucs's glue
takes: the card time of the kernels other than `rowmm*` and
`lstm_cell_kernel` (the rounded copies of operands, GLU, ReLU, the skip
adds, the overlap-adds, the resamplers' interleaving and windows), as a %
of the time the card ran any kernel or copy. Read only where the program
recorded Demucs's spans (`koala_tpu_torch.profiling`): a program without
the model gives nothing."""

from koala_tpu_torch import profiling


def read(run, trace):
    spans = getattr(profiling, "spans", None)
    if not any(s.name.startswith("demucs.") for s in (spans(trace.t0, trace.t1) if spans else ())):
        return None
    busy = trace.busy_s()
    glue = trace.kernel_s(lambda k: "rowmm" not in k and "lstm_cell_kernel" not in k)
    return 100.0 * glue / busy if busy > 0 else None
