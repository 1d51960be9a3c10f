"""Work of the `mask_gru` kind (frozen copies of the program's `bound()`s:
`ops/kernels/{rowmm,gru,floor,engine_fused}.py`), at a configuration's
widths: 257 bins, nb SNR bands, 161 cepstral lags, enc_in = 257 + 2 nb + cep
encoder inputs, hidden H, L layers, 257 mask columns and the gate."""

from .peaks import least_s

FFT, BINS, LAGS = 512, 257, 161


def widths(cfg):
    nb = cfg.get("snr_bands") or 0
    cep = cfg.get("cep_feats") or 0
    enc_in = BINS + nb * (2 if cfg.get("floor_feat") else 1) + cep
    return nb, cep, enc_in, cfg["hidden"], cfg["num_layers"]


def spectral_products(cfg):
    """(k, n) of the spectral products of a frame: DFT re and im, band,
    cepstrum, inverse DFT of re and of im."""
    nb, cep, _, _, _ = widths(cfg)
    out = [(FFT, BINS), (FFT, BINS)]
    if nb:
        out.append((BINS, nb))
    if cep:
        out.append((BINS, LAGS))
    return out + [(BINS, FFT), (BINS, FFT)]


def model_products(cfg):
    """(k, n) of the frame-local model products: encoder, decoder, gate."""
    _, _, enc_in, h, _ = widths(cfg)
    return [(enc_in, h), (h, BINS), (h, 1)]


def unfused_products(cfg):
    """The products the unfused engine runs through `rowmm` for each frame
    row, in order: the spectral ones and the model's frame-local ones."""
    s = spectral_products(cfg)
    return s[:-2] + model_products(cfg) + s[-2:]


def rowmm_s(cfg, m: int) -> float:
    """Least seconds of the unfused products at m rows (f32, `rowmm.bound`:
    both operands read and the result written once)."""
    return sum(least_s((m * k + k * n + m * n) * 4, 0, 2 * m * k * n)
               for k, n in unfused_products(cfg))


def gru_ops(cfg, t: int, b: int):
    """(bytes, bf16 ops, f32 ops) of the GRU stack over [t, b] (`gru.bound`)."""
    _, _, _, h, layers = widths(cfg)
    n_bytes = (2 * t * b * h * 2 + 2 * layers * b * h * 4
               + 2 * layers * h * 3 * h * 2 + 2 * layers * 3 * h * 4)
    mm = t * layers * 2 * (2 * b * h * 3 * h)
    ew = t * layers * b * h * 16 + t * layers * b * 3 * h * 2
    return n_bytes, mm, ew


def gru_s(cfg, t: int, b: int) -> float:
    return least_s(*gru_ops(cfg, t, b))


def floor_bytes(cfg, t: int, b: int) -> int:
    """Bytes of the floor tracker over lb [t, b, nb] (`floor.bound`)."""
    nb = widths(cfg)[0]
    return (2 * t * b * nb + 2 * b * nb) * 4


def fused_ops(cfg, b: int, t: int):
    """(bytes, bf16 ops, f32 ops) of the fused entry over hops [b, t, 256]
    (`engine_fused.bound`, with the weights' bytes at their real widths)."""
    nb, cep, enc_in, h, layers = widths(cfg)
    w_elems = (FFT * 2 * BINS + 2 * BINS * FFT + BINS * nb + BINS * LAGS * bool(cep)
               + enc_in * h + layers * 2 * h * 3 * h + h * (BINS + 1))
    w_bytes = w_elems * 2 + (h + layers * 2 * 3 * h + BINS + 1 + cep * h) * 4
    s_bytes = b * (256 * 4 + 2 * 256 * 4 + 2 * nb * 4 + 2 * layers * h * 4)
    n_bytes = 2 * b * t * 256 * 4 + s_bytes + w_bytes
    per_row_mm = 2 * (FFT * 2 * BINS + BINS * nb + (BINS * LAGS if cep else 0) + enc_in * h
                      + layers * 2 * h * 3 * h + h * (BINS + 1) + 2 * BINS * FFT)
    per_row_ew = (BINS * 12 + nb * 12 + cep * (LAGS + h * 2) + h * 12
                  + layers * h * 20 + BINS * 10 + 256 * 2)
    return n_bytes, b * t * per_row_mm, b * t * per_row_ew


def fused_s(cfg, b: int, t: int) -> float:
    return least_s(*fused_ops(cfg, b, t))


def frame_products(cfg, fused: bool):
    """[(flops, precision)] of one frame's products as the configuration
    states them: the model's in its compute dtype; the spectral ones in
    f32 on the engine's path, in the compute dtype in the fused entry."""
    _, _, _, h, layers = widths(cfg)
    model = sum(2 * k * n for k, n in model_products(cfg)) + layers * 2 * 2 * h * 3 * h
    spectral = sum(2 * k * n for k, n in spectral_products(cfg))
    dtype = cfg.get("compute_dtype", "float32")
    return [(model, dtype), (spectral, dtype if fused else "float32")]
