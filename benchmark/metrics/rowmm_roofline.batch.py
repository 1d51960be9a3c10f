"""Share of its roofline that `rowmm` (`csrc/rowmm.cu`) reaches in a batch
cell: the least time of the engine's products on the hops that take the
unfused path (`counts.<kind>.rowmm_s` at B x hops rows, once a batch) over
the card time of the kernels named `rowmm*`."""


def read(run, trace):
    n = trace.delta.get("batches")
    t = trace.kernel_s(lambda k: "rowmm" in k)
    rows = run.batch_rows * (run.hops - getattr(run, "fused_hops", 0))
    if not n or not t or not rows:
        return None
    return 100.0 * n * run.counts.rowmm_s(run.config["model"], rows) / t
