"""Work of the `demucs` kind, at a configuration's widths, a stream-hop
(256 samples at 16 kHz; 1024 positions at 64 kHz, 4^-k of them at encoder
level k): each level's strided convolution (8 C_{k-1} -> C_k) and 1x1
convolution (C_k -> 2 C_k), each decoder level's 1x1 convolution and
transposed convolution (C_k -> 8 C_{k-1}), the resampling FIRs (112 taps:
two upsamplers, two downsamplers) and the hop's mean square, all through
`rowmm`; and the LSTM's layer-steps (a frozen copy of `ops/kernels/lstm.py`'s
`bound()`, at kx = H = C_depth)."""

from .peaks import least_s

HOP, TAPS, KERNEL, STRIDE = 256, 112, 8, 4


def widths(cfg):
    """C_0 .. C_depth."""
    ch, h = [cfg["chin"]], cfg["hidden"]
    for _ in range(cfg["depth"]):
        ch.append(h)
        h = min(int(cfg["growth"] * h), cfg["max_hidden"])
    return ch


def conv_products(cfg):
    """(rows a stream-hop, k, n) of the convolutions' products."""
    ch = widths(cfg)
    work = []
    for k in range(1, cfg["depth"] + 1):
        rows = HOP * cfg["resample"] // STRIDE ** k
        work += [(rows, KERNEL * ch[k - 1], ch[k]), (rows, ch[k], 2 * ch[k]),
                 (rows, ch[k], 2 * ch[k]), (rows, ch[k], KERNEL * ch[k - 1])]
    return work


def resample_products(cfg):
    """(rows a stream-hop, k, n) of the f32 products: the mean square's sum,
    the FIRs at 32 kHz (512 new samples, half of them computed), 64 kHz,
    then 32 and 16 kHz on the way down."""
    return [(1, HOP, 1), (HOP, TAPS, 1), (2 * HOP, TAPS, 1), (2 * HOP, TAPS, 1), (HOP, TAPS, 1)]


def rowmm_s(cfg, m: int) -> float:
    """Least seconds of every `rowmm` product of m stream-hops (f32,
    `rowmm.bound`: both operands read and the result written once)."""
    return sum(least_s((rows * k + k * n + rows * n) * 4, 0, 2 * rows * k * n)
               for rows, k, n in ((m * r, k, n) for r, k, n in
                                  conv_products(cfg) + resample_products(cfg)))


def padded(kx: int) -> int:
    return -(-kx // 16) * 16


def lstm_ops(m: int, kx: int, h: int):
    """(bytes, bf16 ops, f32 ops) of one layer-step over m rows (`lstm.bound`)."""
    n_bytes = (m * kx + 4 * m * h) * 4 + (padded(kx) + h) * 4 * h * 2 + 4 * h * 4
    return n_bytes, 2 * m * (kx + h) * 4 * h, 40 * m * h


def lstm_s(cfg, rows: int, hops: int) -> float:
    """Least seconds of the LSTM kernel's launches over a batch of `rows`
    streams and `hops` hops: each layer-step at its own bound."""
    h = widths(cfg)[-1]
    return hops * cfg["lstm_layers"] * least_s(*lstm_ops(rows, h, h))


def frame_products(cfg, fused: bool):
    """[(flops, precision)] of one stream-hop's products as the
    configuration states them: the convolutions' and the LSTM's in the
    compute dtype, the resampling in f32. No hop takes a fused path."""
    h = widths(cfg)[-1]
    model = sum(2 * r * k * n for r, k, n in conv_products(cfg))
    model += cfg["lstm_layers"] * 2 * (h + h) * 4 * h
    resample = sum(2 * r * k * n for r, k, n in resample_products(cfg))
    return [(model, cfg.get("compute_dtype", "float32")), (resample, "float32")]
