"""Share of the card's peak that a batch cell's whole work reaches: the
products of every hop of every batch issued in the traced stretch, each at
the peak of the precision the configuration states for it
(`counts.<kind>.frame_products`, `counts.peaks`), over the stretch."""

from benchmark.counts.peaks import product_s


def read(run, trace):
    n = trace.delta.get("batches")
    if not n or trace.window_s <= 0:
        return None
    cfg, fused = run.config["model"], getattr(run, "fused_hops", 0)
    frames = [(run.batch_rows * fused, True), (run.batch_rows * (run.hops - fused), False)]
    s = sum(f * product_s(run.counts.frame_products(cfg, path)) for f, path in frames)
    return 100.0 * n * s / trace.window_s
