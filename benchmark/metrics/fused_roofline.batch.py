"""Share of its roofline that the fused entry (`csrc/engine_fused.cu`)
reaches: the least time of its work at the batch's shapes, [B, T8, 256]
with T8 the hops it takes (`counts.mask_gru.fused_s`), over the card time
of its kernels: each segment's front, encode and back kernels and the floor
and GRU kernels launched between a front and the next back."""


def read(run, trace):
    n = trace.delta.get("batches")
    if not n or not getattr(run, "fused_hops", 0):
        return None
    t, inside = 0, False
    for name, a, b in sorted(trace.kernels, key=lambda k: k[1]):
        inside = inside or "front_kernel" in name
        if inside:
            t += b - a
        inside = inside and "back_kernel" not in name
    if not t:
        return None
    least = n * run.counts.fused_s(run.config["model"], run.batch_rows, run.fused_hops)
    return 100.0 * least / (t * 1e-9)
