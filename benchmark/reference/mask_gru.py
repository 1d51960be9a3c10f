"""Plain reference of the `mask_gru` model kind over whole streams.

Per hop of each stream (the model file's config names the switches):

    spectrum (re, im) of [hop t-1 | hop t]      power p = re^2 + im^2
    feat   = (log sqrt(p + eps^2) + shift) * scale                  [257]
    lb     = log(p @ band + eps^2)        mel-spaced band means       [nb]
    floor  = min(floor + rise, lb)        from 30.0 at a stream's start
    snr    = clip((lb - floor) * snr_scale, 0, snr_clip);  lvl = (floor + 9) * 0.15
    cep    = clip(max over lag groups of (0.5 log(p + eps^2) @ cep_basis) * cep_scale, -1, 4)
    x      = gelu_tanh([feat | snr | lvl | cep] @ enc_w + enc_b)
    per GRU layer: z, r, n from x @ wx + bx and h @ wh + bh (gate columns z, r, n),
             n = tanh(xn + r * hn), h = (1 - z) n + z h,  x = x + h
    mask   = sigmoid(x @ dec_w + dec_b);  g = sigmoid(x @ gate_w + gate_b)
    mask   = mask + g (1 - mask);   output = iSTFT(spectrum * mask), overlap-added

Every model product takes its operands in `product` precision (the config's
`compute_dtype`) with float32 sums; the spectral products (DFT, band, cepstrum,
inverse DFT) in the precision that `spectral` gives for each range of hops.
Everything else is float32. The frame-local work runs over all hops at
once; only the floor tracker and the GRU step through time.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .stft import BINS, bases, by_segments, frames_of, overlap_add, prod


@functools.lru_cache(maxsize=None)
def band_matrix(bins: int, nb: int) -> np.ndarray:
    """[bins, nb]: mean over contiguous mel-spaced groups of bins, 0-8 kHz."""
    mel_top = 2595.0 * np.log10(1.0 + 8000.0 / 700.0)
    hz = 700.0 * (10.0 ** (np.linspace(0.0, mel_top, nb + 1) / 2595.0) - 1.0)
    edges = np.maximum(np.round(hz / 8000.0 * (bins - 1)).astype(np.int64), np.arange(nb + 1))
    edges[-1] = bins
    m = np.zeros((bins, nb), np.float32)
    for j in range(nb):
        lo, hi = int(edges[j]), int(edges[j + 1])
        m[lo:hi, j] = 1.0 / max(hi - lo, 1)
    return m


@functools.lru_cache(maxsize=None)
def cep_basis(bins: int, groups: int):
    """([bins, 161] real-cepstrum rows at pitch lags 40..200 of a 512-point
    spectrum, [(lo, hi)] lag columns of each of the geometric groups)."""
    lags = np.arange(40, 201)
    w = np.full((bins, 1), 2.0 / 512.0)
    w[0] = w[-1] = 1.0 / 512.0
    k = np.arange(bins, dtype=np.float64)[:, None]
    basis = (w * np.cos(2.0 * np.pi * k * lags[None, :] / 512.0)).astype(np.float32)
    edges = np.round(40.0 * 5.0 ** (np.arange(groups + 1) / groups)).astype(np.int64)
    return basis, tuple((int(edges[g] - 40), int(edges[g + 1] - 39)) for g in range(groups))


class Weights:
    """The model file's tensors on a device (float32)."""

    def __init__(self, flat, config, device):
        def t(name):
            return torch.as_tensor(flat[name], device=device)

        self.cfg = dict(config)
        self.enc_w, self.enc_b = t("enc/w"), t("enc/b")
        self.gru = [(t("gru/%d/wx" % i), t("gru/%d/bx" % i), t("gru/%d/wh" % i), t("gru/%d/bh" % i))
                    for i in range(self.cfg["num_layers"])]
        self.dec_w, self.dec_b = t("dec/w"), t("dec/b")
        self.gate_w, self.gate_b = t("gate/w"), t("gate/b")


def _floor_track(lb, rise):
    floor = torch.full_like(lb[:, 0], 30.0)
    out = []
    for t in range(lb.shape[1]):
        floor = torch.minimum(floor + rise, lb[:, t])
        out.append(floor)
    return torch.stack(out, dim=1)


def _gru_layer(x, wx, bx, wh, bh, product):
    xp = prod(x, wx, product) + bx
    h = torch.zeros(x.shape[0], wh.shape[0], device=x.device)
    hs = []
    for t in range(x.shape[1]):
        hp = prod(h, wh, product) + bh
        xz, xr, xn = xp[:, t].chunk(3, dim=-1)
        hz, hr, hn = hp.chunk(3, dim=-1)
        z = torch.sigmoid(xz + hz)
        r = torch.sigmoid(xr + hr)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


@torch.no_grad()
def enhance(w: Weights, hops: torch.Tensor, product: str, spectral, keep=None) -> torch.Tensor:
    """hops [B, T, 256] float32 of fresh streams -> enhanced hops [B, T, 256].
    `spectral`: [(lo, hi, precision)] over the hop axis. A dict `keep` gets
    the layers' outputs: spectrum, features, encoder, each GRU layer's, mask."""
    keep = {} if keep is None else keep
    cfg = w.cfg
    dev = hops.device
    eps2 = cfg["feat_eps"] ** 2
    fwd, inv = bases(dev)
    spec = by_segments(lambda f, d: prod(f, fwd, d), frames_of(hops), spectral)
    re, im = spec[..., :BINS], spec[..., BINS:]
    keep["spectrum"] = spec
    power = re * re + im * im
    parts = [(torch.log(torch.sqrt(power + eps2)) + cfg["feat_shift"]) * cfg["feat_scale"]]
    nb = cfg.get("snr_bands") or 0
    if nb:
        band = torch.as_tensor(band_matrix(BINS, nb), device=dev)
        lb = torch.log(by_segments(lambda p, d: prod(p, band, d), power, spectral) + eps2)
        floor = _floor_track(lb, cfg["floor_rise"])
        parts.append(torch.clamp((lb - floor) * cfg["snr_scale"], 0.0, cfg["snr_clip"]))
        if cfg.get("floor_feat"):
            parts.append((floor + 9.0) * 0.15)
    if cfg.get("cep_feats"):
        basis, groups = cep_basis(BINS, cfg["cep_feats"])
        basis = torch.as_tensor(basis, device=dev)
        logmag = 0.5 * torch.log(power + eps2)
        c = by_segments(lambda a, d: prod(a, basis, d), logmag, spectral)
        gmax = torch.stack([c[..., lo:hi].amax(dim=-1) for lo, hi in groups], dim=-1)
        parts.append(torch.clamp(gmax * cfg["cep_scale"], -1.0, 4.0))
    keep["features"] = torch.cat(parts, dim=-1)
    x = F.gelu(prod(keep["features"], w.enc_w, product) + w.enc_b, approximate="tanh")
    keep["encoder"] = x
    for i, (wx, bx, wh, bh) in enumerate(w.gru):
        keep["gru%d" % i] = _gru_layer(x, wx, bx, wh, bh, product)
        x = x + keep["gru%d" % i]
    mask = torch.sigmoid(prod(x, w.dec_w, product) + w.dec_b)
    g = torch.sigmoid(prod(x, w.gate_w, product) + w.gate_b)
    mask = mask + g * (1.0 - mask)
    keep["mask"] = mask
    masked = torch.cat([re * mask, im * mask], dim=-1)
    synth = by_segments(lambda s, d: prod(s, inv, d), masked, spectral)
    return overlap_add(synth)


class Reference:
    """The model of a configuration file (its `model_file`, read by `pv`)."""

    def __init__(self, config, model_path, device):
        from .pv import read_pv
        flat, file_cfg = read_pv(model_path)
        self.weights = Weights(flat, dict(file_cfg, **config["model"]), device)

    def enhance(self, hops, precision, fused_hops=0, keep=None):
        """`precision`: {"products", "spectral", "fused_spectral"}; the first
        `fused_hops` hops take `fused_spectral` for the spectral products."""
        t = hops.shape[1]
        spectral = [(0, fused_hops, precision.get("fused_spectral", precision["spectral"])),
                    (fused_hops, t, precision["spectral"])]
        return enhance(self.weights, hops, precision["products"], spectral, keep)
