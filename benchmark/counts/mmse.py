"""Work of the `mmse` kind: the engine's spectral products (DFT re and im,
inverse DFT of re and of im) through `rowmm` in f32; its gain loop is
elementwise and has no products."""

from .peaks import least_s

FFT, BINS = 512, 257


def unfused_products(cfg):
    return [(FFT, BINS), (FFT, BINS), (BINS, FFT), (BINS, FFT)]


def rowmm_s(cfg, m: int) -> float:
    return sum(least_s((m * k + k * n + m * n) * 4, 0, 2 * m * k * n)
               for k, n in unfused_products(cfg))


def frame_products(cfg, fused: bool):
    return [(sum(2 * k * n for k, n in unfused_products(cfg)), "float32")]
