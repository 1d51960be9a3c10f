"""FullSubNet: a full-band and a sub-band LSTM with a complex ratio mask.

Hao, Su, Horaud and Li, "FullSubNet: A Full-Band and Sub-Band Fusion Model
for Real-Time Single-Channel Speech Enhancement", ICASSP 2021
(arXiv:2010.15508), streamed frame by frame. Per frame t of a stream, with
|X| the noisy magnitude [F = 257]:

    full band  fb_in = |X| / (m_t + 1e-5), m_t the mean of |X| over all bins
               and frames 0..t;  2-layer LSTM (F -> Hf -> Hf), Linear(Hf -> F),
               ReLU -> fb [F]
    sub band   for each bin f: |X| at f-15 .. f+15 (reflected at the edges)
               and fb[f]: 32 features, divided by (their mean over the 32
               features and frames 0..t of that bin + 1e-5);  a 2-layer LSTM
               (32 -> Hs -> Hs) shared by the F bins, on B x F rows;
               Linear(Hs -> 2)
    mask       m = clamp(m, -9.9, 9.9);  M = -K log((K - m) / (K + m)), K = 10
               -> (M_re, M_im), applied by the engine as a complex product

The LSTM cell is PyTorch's (gates i, f, g, o; two biases). Both the step
(one frame) and the sequence (T frames) run the same per-frame function: the
sub-band gates of a whole chunk would not fit on the card (B = 2048, T = 375:
about 1.2 TB), so the sequence walks its frames one by one, and the
cumulative means are carried as running sums, one add a frame, in both. Each
frame's sums over bins and over a bin's 32 features go through
``rowmm`` (a fixed order), so a stream's bits do not depend on its batch
or on how its frames were cut into calls. ``drop_band`` (a training-time
cut of the bins) does not apply to inference; ``look_ahead`` 0 keeps the
engine's one-hop delay.

Products take bf16 operands with f32 sums (``compute_dtype: bfloat16``):
the four LSTM layer-steps of a frame through ``ops/kernels/lstm.py`` (on a
card the kernel of csrc/lstm.cu, product and cell in one launch), the two
output layers through ``rowmm`` on bf16-rounded operands. States, the
normalisation and the mask are f32. With ``compute_dtype: float32`` every
product is an f32 ``rowmm`` (the CPU tests' setting).

State, batch axes leading: fb_h, fb_c [*, L, Hf]; sb_h, sb_c [*, F, L, Hs];
the running sums fb_sum [*] and sb_sum [*, F]; count [*] (frames seen).

Under a profiler each frame records the spans ``fullsubnet.fullband``
(counts ``frames``, ``rows``: the streams) and ``fullsubnet.subband``
(``frames``, ``rows``: streams x F, ``launches``: the LSTM and ``rowmm``
kernels it launched; see ``profiling.span``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .. import profiling
from ..constants import NUM_BINS
from ..ops.kernels import lstm, rowmm
from ..ops.kernels.rowmm import matmul
from .base import ParamModule, constant_on, num_params, param

DEFAULT_CONFIG = {
    "kind": "fullsubnet",
    "bins": NUM_BINS,
    "fb_hidden": 512,
    "fb_layers": 2,
    "fb_num_neighbors": 0,
    "fb_activation": "relu",
    "sb_hidden": 384,
    "sb_layers": 2,
    "sb_num_neighbors": 15,
    "look_ahead": 0,
    "norm": "cumulative_laplace",
    "crm_k": 10,
    "crm_limit": 9.9,
    "compute_dtype": "bfloat16",
}

EPS = 1e-5          # added to each cumulative mean before the division


def resolve(config: Dict[str, Any] = None) -> Dict[str, Any]:
    """The config over the defaults, checked: what this port takes of
    FullSubNet's settings."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    for key, want in (("fb_num_neighbors", 0), ("look_ahead", 0),
                      ("norm", "cumulative_laplace"), ("fb_activation", "relu")):
        if cfg[key] != want:
            raise ValueError("fullsubnet: %s %r is not supported (only %r)"
                             % (key, cfg[key], want))
    if cfg["compute_dtype"] not in ("bfloat16", "float32"):
        raise ValueError("fullsubnet: compute_dtype %r" % cfg["compute_dtype"])
    if not 0 < cfg["sb_num_neighbors"] < cfg["bins"] - 1:
        raise ValueError("fullsubnet: sb_num_neighbors %r for %r bins"
                         % (cfg["sb_num_neighbors"], cfg["bins"]))
    return cfg


def sb_features(cfg) -> int:
    """Inputs of the sub-band model a bin: its neighbourhood and the full-band
    output's (fb_num_neighbors 0: the bin's own)."""
    return 2 * cfg["sb_num_neighbors"] + 1 + 2 * cfg["fb_num_neighbors"] + 1


class LSTMLayer(nn.Module):
    """PyTorch's LSTM layer: w_ih [4H, in], w_hh [4H, H], b_ih, b_hh [4H],
    gate blocks i, f, g, o."""

    def __init__(self, t):
        super().__init__()
        self.w_ih, self.w_hh = param(t["w_ih"]), param(t["w_hh"])
        self.b_ih, self.b_hh = param(t["b_ih"]), param(t["b_hh"])


class Linear(nn.Module):
    """w [out, in], b [out] (PyTorch's orientation)."""

    def __init__(self, t):
        super().__init__()
        self.w, self.b = param(t["w"]), param(t["b"])


class Branch(nn.Module):
    """One of the two sequence models: an LSTM stack and a Linear."""

    def __init__(self, t):
        super().__init__()
        self.lstm = nn.ModuleList(LSTMLayer(layer) for layer in t["lstm"])
        self.fc = Linear(t["fc"])


class FullSubNet(ParamModule):
    """Parameters of the model (``fb/lstm/0/w_ih`` -> ``fb.lstm.0.w_ih``)."""

    def __init__(self, tree):
        super().__init__()
        self.fb = Branch(tree["fb"])
        self.sb = Branch(tree["sb"])

    def cell_operands(self, branch: str, i: int, dtype: str):
        """Layer ``i`` of a branch as the cell takes it: bf16, the kernel's
        (w [4H, padded(in) + H] in pass order, b_ih + b_hh); f32, (w [in + H, 4H], b)."""
        layer = getattr(self, branch).lstm[i]

        def build():
            if dtype == "bfloat16":
                return lstm.stack_weights(layer.w_ih, layer.w_hh, layer.b_ih, layer.b_hh)
            return (torch.cat([layer.w_ih, layer.w_hh], dim=1).t().contiguous(),
                    (layer.b_ih + layer.b_hh).contiguous())
        return self.derived("cell:%s.%d:%s" % (branch, i, dtype), build)

    def fc_operand(self, branch: str, dtype: str) -> torch.Tensor:
        """The output layer's weight [in, out], rounded to the compute dtype
        and held as f32 (``rowmm``'s right operand)."""
        w = getattr(self, branch).fc.w
        rnd = (lambda t: t.bfloat16().float()) if dtype == "bfloat16" else (lambda t: t)
        return self.derived("fc:%s:%s" % (branch, dtype), lambda: rnd(w.t()).contiguous())


Params = FullSubNet


def init_params(generator: torch.Generator, config: Dict[str, Any] = None) -> FullSubNet:
    """Fresh weights on the generator's device: PyTorch's default LSTM and
    Linear initialisation, every weight and bias uniform in +-1/sqrt(fan)
    (the hidden width for an LSTM, the input width for a Linear)."""
    cfg = resolve(config)
    dev = generator.device

    def uniform(shape, fan):
        return (torch.rand(shape, generator=generator, device=dev) * 2.0 - 1.0) / np.sqrt(fan)

    def branch(k_in, hid, layers, out):
        stack = [{"w_ih": uniform((4 * hid, k_in if i == 0 else hid), hid),
                  "w_hh": uniform((4 * hid, hid), hid),
                  "b_ih": uniform((4 * hid,), hid), "b_hh": uniform((4 * hid,), hid)}
                 for i in range(layers)]
        return {"lstm": stack, "fc": {"w": uniform((out, hid), hid), "b": uniform((out,), hid)}}

    bins = cfg["bins"]
    return FullSubNet({
        "fb": branch(bins, cfg["fb_hidden"], cfg["fb_layers"], bins),
        "sb": branch(sb_features(cfg), cfg["sb_hidden"], cfg["sb_layers"], 2),
    })


def init_state(batch_shape: Tuple[int, ...], config: Dict[str, Any], device):
    cfg = resolve(config)
    lead = tuple(batch_shape)
    dev = torch.device(device)
    f, hf, hs = cfg["bins"], cfg["fb_hidden"], cfg["sb_hidden"]

    def zeros(*shape):
        return torch.zeros(lead + shape, device=dev)

    return {"fb_h": zeros(cfg["fb_layers"], hf), "fb_c": zeros(cfg["fb_layers"], hf),
            "sb_h": zeros(f, cfg["sb_layers"], hs), "sb_c": zeros(f, cfg["sb_layers"], hs),
            "fb_sum": zeros(), "sb_sum": zeros(f), "count": zeros()}


def _neighbours(bins: int, n: int) -> np.ndarray:
    """[bins, 2n + 1] bin indices f - n .. f + n, reflected at the edges
    (torch's reflect padding: -1 -> 1)."""
    idx = np.arange(bins)[:, None] + np.arange(-n, n + 1)[None, :]
    idx = np.where(idx < 0, -idx, idx)
    return np.where(idx > bins - 1, 2 * (bins - 1) - idx, idx).astype(np.int64)


def _ones(n: int) -> np.ndarray:
    """[n, 1] ones, the right operand of a fixed-order row sum."""
    return np.ones((n, 1), np.float32)


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """x [..., K] -> [...]: each row summed in ``rowmm``'s fixed order."""
    return matmul(x, constant_on(_ones, x.device, x.shape[-1])).squeeze(-1)


def _linear(x, params: FullSubNet, branch: str, cfg):
    """An output layer: x @ w^T + b, bf16 operands (or f32) and f32 sums."""
    if cfg["compute_dtype"] == "bfloat16":
        x = x.bfloat16().float()
    w = params.fc_operand(branch, cfg["compute_dtype"])
    return matmul(x, w) + getattr(params, branch).fc.b


def _stack(params: FullSubNet, branch: str, x, h, c, h_new, c_new, cfg):
    """The LSTM stack of a branch over rows: x [M, in]; h, c [M, L, H] (the
    frame's state) -> the top layer's h' [M, H], h_new and c_new [M, L, H]
    written layer by layer."""
    dtype = cfg["compute_dtype"]
    for i in range(h.shape[1]):
        w, b = params.cell_operands(branch, i, dtype)
        if dtype == "bfloat16":
            lstm.lstm_cell(x, h[:, i], c[:, i], w, b, h_new[:, i], c_new[:, i])
        else:
            gates = matmul(torch.cat([x, h[:, i]], dim=-1), w) + b
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            c_new[:, i] = torch.sigmoid(gf) * c[:, i] + torch.sigmoid(gi) * torch.tanh(gg)
            h_new[:, i] = torch.sigmoid(go) * torch.tanh(c_new[:, i])
        x = h_new[:, i]
    return x


def _frame(params: FullSubNet, st, mag, cfg):
    """One frame of n streams: state (batch axis n) and mag [n, F] ->
    (state', (mask_re, mask_im) [n, F])."""
    n, f = mag.shape
    width = sb_features(cfg)
    count = st["count"] + 1.0
    new = {k: torch.empty_like(st[k]) for k in ("fb_h", "fb_c", "sb_h", "sb_c")}
    new["count"] = count
    with profiling.span("fullsubnet.fullband", frames=1, rows=n):
        new["fb_sum"] = st["fb_sum"] + _row_sum(mag)
        fb_in = mag / (new["fb_sum"] / (count * f) + EPS).unsqueeze(-1)
        x = _stack(params, "fb", fb_in, st["fb_h"], st["fb_c"], new["fb_h"], new["fb_c"], cfg)
        fb = torch.relu(_linear(x, params, "fb", cfg))                           # [n, F]
    with profiling.counted_span("fullsubnet.subband", lambda: lstm.launches + rowmm.launches,
                                frames=1, rows=n * f):
        idx = constant_on(_neighbours, mag.device, f, cfg["sb_num_neighbors"])
        feats = torch.cat([mag[:, idx], fb.unsqueeze(-1)], dim=-1)              # [n, F, 32]
        new["sb_sum"] = st["sb_sum"] + _row_sum(feats)
        sb_in = feats / (new["sb_sum"] / (count.unsqueeze(-1) * width) + EPS).unsqueeze(-1)
        rows = n * f
        shape = (rows,) + st["sb_h"].shape[-2:]
        x = _stack(params, "sb", sb_in.reshape(rows, width), st["sb_h"].reshape(shape),
                   st["sb_c"].reshape(shape), new["sb_h"].view(shape), new["sb_c"].view(shape),
                   cfg)
        m = _linear(x, params, "sb", cfg).reshape(n, f, 2)
        k, limit = float(cfg["crm_k"]), float(cfg["crm_limit"])
        m = torch.clamp(m, -limit, limit)
        mask = -k * torch.log((k - m) / (k + m))
    return new, (mask[..., 0], mask[..., 1])


# the axes of each state leaf past the batch axes
_TAIL = {"fb_h": 2, "fb_c": 2, "sb_h": 3, "sb_c": 3, "fb_sum": 0, "sb_sum": 1, "count": 0}


def _flat(state, n: int):
    return {k: v.reshape((n,) + v.shape[v.dim() - _TAIL[k]:]) for k, v in state.items()}


def _unflat(state, lead):
    return {k: v.reshape(lead + v.shape[v.dim() - _TAIL[k]:]) for k, v in state.items()}


def step(params: FullSubNet, state, re, im, config: Dict[str, Any] = None):
    """Single-frame step: (state, [*, F] spectrum) -> (state', (mask_re,
    mask_im) [*, F])."""
    cfg = resolve(config)
    lead = re.shape[:-1]
    n = int(np.prod(lead, dtype=np.int64))
    mag = torch.sqrt(re * re + im * im).reshape(n, re.shape[-1])
    st, (mr, mi) = _frame(params, _flat(state, n), mag, cfg)
    return _unflat(st, lead), (mr.reshape(re.shape), mi.reshape(re.shape))


def apply_sequence(params: FullSubNet, state, re, im, config: Dict[str, Any] = None):
    """Sequence mode: spectra [*, T, F] -> (final state, (mask_re, mask_im)
    [*, T, F]): the frames one by one through the step's arithmetic."""
    cfg = resolve(config)
    lead, (t_len, f) = re.shape[:-2], re.shape[-2:]
    n = int(np.prod(lead, dtype=np.int64))
    mag = torch.sqrt(re * re + im * im).reshape(n, t_len, f)
    st = _flat(state, n)
    mr = torch.empty((n, t_len, f), device=re.device)
    mi = torch.empty((n, t_len, f), device=re.device)
    for t in range(t_len):
        st, (mr[:, t], mi[:, t]) = _frame(params, st, mag[:, t], cfg)
    return _unflat(st, lead), (mr.reshape(re.shape), mi.reshape(re.shape))


__all__ = ["DEFAULT_CONFIG", "EPS", "FullSubNet", "Params", "resolve", "sb_features", "init_params",
           "init_state", "step", "apply_sequence", "num_params"]
