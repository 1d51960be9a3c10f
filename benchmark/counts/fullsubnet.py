"""Work of the `fullsubnet` kind, at a configuration's widths: the engine's
spectral products through `rowmm` in f32 (DFT re and im, inverse DFT of re
and of im), the model's per-frame `rowmm` products (the full band's bin sum
and output layer on each stream's row, the sub-band's feature sum and output
layer on each of its 257 rows), and the four LSTM layer-steps of each frame
(a frozen copy of `ops/kernels/lstm.py`'s `bound()`)."""

from .peaks import least_s

FFT, BINS = 512, 257


def widths(cfg):
    """(bins, full-band hidden and layers, sub-band hidden and layers, the
    sub-band's features a bin)."""
    feats = 2 * cfg["sb_num_neighbors"] + 1 + 2 * cfg["fb_num_neighbors"] + 1
    return (cfg["bins"], cfg["fb_hidden"], cfg["fb_layers"], cfg["sb_hidden"],
            cfg["sb_layers"], feats)


def unfused_products(cfg):
    """(k, n) of the engine's spectral products of a frame."""
    return [(FFT, BINS), (FFT, BINS), (BINS, FFT), (BINS, FFT)]


def model_rowmm_products(cfg):
    """(rows a frame row, k, n) of the model's `rowmm` products: the sums
    are products with a column of ones."""
    bins, hf, _, hs, _, feats = widths(cfg)
    return [(1, bins, 1), (1, hf, bins), (bins, feats, 1), (bins, hs, 2)]


def rowmm_s(cfg, m: int) -> float:
    """Least seconds of every `rowmm` product of m frame rows (f32,
    `rowmm.bound`: both operands read and the result written once)."""
    work = [(m, k, n) for k, n in unfused_products(cfg)]
    work += [(m * r, k, n) for r, k, n in model_rowmm_products(cfg)]
    return sum(least_s((rows * k + k * n + rows * n) * 4, 0, 2 * rows * k * n)
               for rows, k, n in work)


def cells(cfg):
    """(rows a frame row, kx, H) of each LSTM layer-step of a frame."""
    bins, hf, lf, hs, ls, feats = widths(cfg)
    return ([(1, bins if i == 0 else hf, hf) for i in range(lf)]
            + [(bins, feats if i == 0 else hs, hs) for i in range(ls)])


def padded(kx: int) -> int:
    return -(-kx // 16) * 16


def lstm_ops(m: int, kx: int, h: int):
    """(bytes, bf16 ops, f32 ops) of one layer-step over m rows (`lstm.bound`)."""
    n_bytes = (m * kx + 4 * m * h) * 4 + (padded(kx) + h) * 4 * h * 2 + 4 * h * 4
    return n_bytes, 2 * m * (kx + h) * 4 * h, 40 * m * h


def lstm_s(cfg, rows: int, hops: int) -> float:
    """Least seconds of the LSTM kernel's launches over a batch of `rows`
    streams and `hops` frames: each layer-step at its own bound."""
    return hops * sum(least_s(*lstm_ops(rows * r, kx, h)) for r, kx, h in cells(cfg))


def frame_products(cfg, fused: bool):
    """[(flops, precision)] of one frame's products as the configuration
    states them: the LSTMs' and output layers' in the compute dtype, the
    engine's STFT and iSTFT in f32. No hop takes a fused path."""
    bins, hf, _, hs, _, _ = widths(cfg)
    model = sum(r * 2 * (kx + h) * 4 * h for r, kx, h in cells(cfg))
    model += 2 * hf * bins + bins * 2 * hs * 2
    spectral = sum(2 * k * n for k, n in unfused_products(cfg))
    return [(model, cfg.get("compute_dtype", "float32")), (spectral, "float32")]
