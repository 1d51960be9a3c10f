"""Plain reference of the `fullsubnet` model kind over whole streams.

FullSubNet (Hao, Su, Horaud and Li, ICASSP 2021, arXiv:2010.15508), causal,
frame by frame. Per hop t of each stream, with (re, im) the spectrum of
[hop t-1 | hop t] and mag = sqrt(re^2 + im^2) [257]:

    full band  s = s + sum(mag);  fb_in = mag / (s / (257 (t + 1)) + 1e-5)
               2 LSTM layers, then relu(x @ fc_w^T + fc_b) -> fb [257]
    sub band   feats[f] = [mag[f-15 .. f+15] reflected at the edges | fb[f]]  [257, 32]
               z[f] = z[f] + sum(feats[f]);  sb_in[f] = feats[f] / (z[f] / (32 (t + 1)) + 1e-5)
               2 LSTM layers on the 257 rows (weights shared), then x @ fc_w^T + fc_b -> m [257, 2]
    mask       m = clamp(m, -9.9, 9.9);  M = -10 log((10 - m) / (10 + m))
    output     iSTFT((M_re re - M_im im) + j (M_im re + M_re im)), overlap-added

An LSTM layer: gates = x @ w_ih^T + b_ih + h @ w_hh^T + b_hh, in the blocks
i, f, g, o;  c = sigmoid(f) c + sigmoid(i) tanh(g);  h = sigmoid(o) tanh(c),
from zeros at a stream's start. Every model product takes its operands in
`products` precision with float32 sums; the spectral products in
`spectral` precision. Everything else is float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .stft import BINS, bases, frames_of, overlap_add, prod

EPS = 1e-5


def neighbours(bins: int, n: int) -> np.ndarray:
    """[bins, 2n + 1]: the bins f - n .. f + n, reflected at the edges
    (-1 -> 1, bins -> bins - 2)."""
    idx = np.arange(bins)[:, None] + np.arange(-n, n + 1)[None, :]
    idx = np.abs(idx)
    return np.where(idx > bins - 1, 2 * (bins - 1) - idx, idx)


class Weights:
    """The model file's tensors on a device (float32)."""

    def __init__(self, flat, config, device):
        self.cfg = dict(config)

        def t(name):
            return torch.as_tensor(flat[name], device=device)

        def branch(name, layers):
            stack = [tuple(t("%s/lstm/%d/%s" % (name, i, k))
                           for k in ("w_ih", "b_ih", "w_hh", "b_hh")) for i in range(layers)]
            return stack, t(name + "/fc/w"), t(name + "/fc/b")

        self.fb = branch("fb", self.cfg["fb_layers"])
        self.sb = branch("sb", self.cfg["sb_layers"])


def _stack(x, h, c, layers, product):
    """The LSTM layers over rows x [M, in]; h, c lists of [M, H] (updated)."""
    for i, (w_ih, b_ih, w_hh, b_hh) in enumerate(layers):
        gates = prod(x, w_ih.t(), product) + b_ih + prod(h[i], w_hh.t(), product) + b_hh
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        c[i] = torch.sigmoid(gf) * c[i] + torch.sigmoid(gi) * torch.tanh(gg)
        h[i] = torch.sigmoid(go) * torch.tanh(c[i])
        x = h[i]
    return x


@torch.no_grad()
def enhance(w: Weights, hops: torch.Tensor, product: str, spectral: str) -> torch.Tensor:
    """hops [B, T, 256] float32 of fresh streams -> enhanced hops [B, T, 256]."""
    cfg = w.cfg
    dev = hops.device
    b, t_len = hops.shape[:2]
    fwd, inv = bases(dev)
    spec = prod(frames_of(hops), fwd, spectral)
    re, im = spec[..., :BINS], spec[..., BINS:]
    mag = torch.sqrt(re * re + im * im)
    n = cfg["sb_num_neighbors"]
    width = 2 * n + 2
    idx = torch.as_tensor(neighbours(BINS, n), device=dev)
    fb_layers, fb_w, fb_b = w.fb
    sb_layers, sb_w, sb_b = w.sb
    hf, hs = cfg["fb_hidden"], cfg["sb_hidden"]
    fh = [torch.zeros(b, hf, device=dev) for _ in fb_layers]
    fc = [torch.zeros(b, hf, device=dev) for _ in fb_layers]
    sh = [torch.zeros(b * BINS, hs, device=dev) for _ in sb_layers]
    sc = [torch.zeros(b * BINS, hs, device=dev) for _ in sb_layers]
    fb_sum = torch.zeros(b, device=dev)
    sb_sum = torch.zeros(b, BINS, device=dev)
    k, limit = float(cfg["crm_k"]), float(cfg["crm_limit"])
    masks = []
    for t in range(t_len):
        m = mag[:, t]
        fb_sum = fb_sum + m.sum(dim=-1)
        x = _stack(m / (fb_sum / (BINS * (t + 1.0)) + EPS)[:, None], fh, fc, fb_layers, product)
        fb = torch.relu(prod(x, fb_w.t(), product) + fb_b)
        feats = torch.cat([m[:, idx], fb[..., None]], dim=-1)                 # [B, 257, 32]
        sb_sum = sb_sum + feats.sum(dim=-1)
        sb_in = feats / (sb_sum / (width * (t + 1.0)) + EPS)[..., None]
        x = _stack(sb_in.reshape(b * BINS, width), sh, sc, sb_layers, product)
        crm = torch.clamp(prod(x, sb_w.t(), product) + sb_b, -limit, limit)
        masks.append((-k * torch.log((k - crm) / (k + crm))).reshape(b, BINS, 2))
    mask = torch.stack(masks, dim=1)                                          # [B, T, 257, 2]
    mr, mi = mask[..., 0], mask[..., 1]
    y = torch.cat([mr * re - mi * im, mi * re + mr * im], dim=-1)
    return overlap_add(prod(y, inv, spectral))


class Reference:
    """The model of a configuration file (its `model_file`, read by `pv`)."""

    def __init__(self, config, model_path, device):
        from .pv import read_pv
        flat, file_cfg = read_pv(model_path)
        self.weights = Weights(flat, dict(file_cfg, **config["model"]), device)

    def enhance(self, hops, precision, fused_hops=0):
        """`precision`: {"products", "spectral"}; no hop takes a fused path."""
        return enhance(self.weights, hops, precision["products"], precision["spectral"])
