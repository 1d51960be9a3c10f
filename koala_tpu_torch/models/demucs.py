"""Demucs, causal, as denoiser's ``dns64``: a waveform U-Net with an LSTM,
streamed exactly at the engine's 256-sample hop.

Défossez, Synnaeve and Adi, "Real Time Speech Enhancement in the Waveform
Domain", Interspeech 2020 (arXiv:2006.12847); https://github.com/facebookresearch/denoiser,
``denoiser/pretrained.py`` ``dns64`` = ``Demucs(hidden=64)``. The model takes
hops and returns hops (``domain = "waveform"``): no STFT, no mask. x is the
16 kHz stream, s its scale:

    u      = up2(up2(x / (floor + s)))                           16 -> 64 kHz
    e_k    = GLU(Conv1d(C_k -> 2 C_k, 1)(ReLU(Conv1d(C_{k-1} -> C_k, 8, stride 4)(e_{k-1}))))
             k = 1 .. 5, e_0 = u, C = 1, 64, 128, 256, 512, 1024 (no padding)
    d_5    = LSTM(1024, 1024, 2 layers)(e_5)                     one frame a hop
    d_{k-1} = ConvTranspose1d(C_k -> C_{k-1}, 8, stride 4)(GLU(Conv1d(C_k -> 2 C_k, 1)(d_k + e_k))),
             then ReLU but for the last level
    y      = s * down2(down2(d_0))                               64 -> 16 kHz

with GLU(z) = z[:C] sigmoid(z[C:]) over channels and denoiser's resampler
(``up2``/``down2``: a 112-tap windowed sinc, 56 zeros of padding). The
total stride 4^5 at 64 kHz is 256 samples at 16 kHz: one bottleneck frame a
hop. Output sample m needs input up to m + 764, so the model declares
``delay_hops`` = 3 (768 samples): output hop t is the offline forward's hop
t - 3, hops 0-2 of a fresh stream are zeros. The scale is causal: s_r =
sqrt(v_r), v_r the mean over hops 0..r of each hop's mean square, carried
as a running sum and a count; input hop r is divided by floor + s_r, output
hop r multiplied by s_r.

Streaming. Every stage is position-parallel with a fixed carry, so a block
of T hops is computed level by level over all its positions at once, and
only the LSTM walks the hops. Each stage emits P positions a hop (its
rate's share of 256 samples) lagging the input by a fixed number of
positions (``layout``): the upsamplers lag 56 input samples each; encoder
level k emits every frame whose window is complete and carries the 4 to 7
input positions a later frame needs; the bottleneck frame of hop t is frame
t - 2; decoder level k emits 4^(5-k) x 2 positions behind it (a transposed
convolution completes a position once the next frame's overlap has been
added, and carries that overlap, 4 positions x C_{k-1}); each skip waits
for its decoder partner in a buffer that also holds the next encoder
level's carry; the downsamplers carry 112 pairs, and the last carries
enough pairs to emit exactly the hop ``delay_hops`` back. Positions before
a stream's start are the resamplers' zero padding and no convolution's
context: they are zeroed where they would reach a position at or after 0
(the upsampled input, the LSTM state, each transposed convolution's
overlap from position -1, d_0 and the first downsampler's output).

Products take bf16 operands with f32 sums (``compute_dtype: bfloat16``):
each convolution and transposed convolution through ``rowmm`` on
bf16-rounded operands (a window of 8 positions x C channels, channels last,
is a row-strided view: im2col copies nothing), a transposed convolution as
one product [rows, C_k] @ [C_k, 8 C_{k-1}] and the sum of its two
overlapping halves in a fixed order; the LSTM's layer-steps through
``ops/kernels/lstm.py``; the resampling FIRs as f32 ``rowmm`` products. The
states, the normalisation, GLU, ReLU and the skip adds are f32. With
``compute_dtype: float32`` every product is an f32 ``rowmm`` (the CPU
tests'). Every row's arithmetic is the same in any block, so ``step`` and
``apply_sequence`` give the same bits for any cut of a stream into calls.

The glue around the products is fused into them (``_encoder``,
``_decoder``): ``rowmm.fused`` rounds a product's f32 operand as it loads it
and applies the bias, ReLU, GLU and the rounding of the next operand to
each element after its sum, writing the encoder's GLU into its skip buffer;
``overlap.overlap_add`` finishes each transposed convolution (the
overlap-add, bias, ReLU, the next level's skip add and rounding, the carried
overlap) in one pass. Each fused op is the IEEE f32 operation of the PyTorch
op it stands for, so the bits are those of ``_encoder_plain`` and
``_decoder_plain``, the same stages as separate PyTorch passes.

State, batch axes leading: the resamplers' carries ``resample_in``
[*, 111], ``resample_up`` [*, 111], ``resample_down`` [*, 224],
``resample_out`` [*, 256 delay_hops - 484 pairs]; ``enc_in`` [*, 4]; the
skips ``skip1`` .. ``skip4`` [*, n_k, C_k]; the overlaps ``overlap1`` ..
``overlap5`` [*, 4, C_{k-1}]; ``lstm_h``, ``lstm_c`` [*, 2, 1024]; the
running sum ``ms_sum`` [*], ``count`` [*] (hops seen) and the last
``delay_hops`` scales ``scales``.

Weights: ``init_params`` draws PyTorch's default Conv1d, ConvTranspose1d
and LSTM initialisation from a generator, then denoiser's
``rescale_module(reference=0.1)``; a model file whose tree is the
weightless placeholder and whose config carries ``init_seed`` is drawn so
at load (``params_from_tree``). Names and layouts are denoiser's
``state_dict``'s (``encoder.{k}.{0,2}``, ``decoder.{k}.{0,2}``,
``lstm.lstm.weight_ih_l{n}``), so a converted checkpoint loads as it is.

Under a profiler a block records the spans ``demucs.resample`` (twice: the
normalisation and upsamplers, then the downsamplers and scale; counts
``hops``, ``launches``), ``demucs.encoder`` and ``demucs.decoder``
(``hops``, ``rows``: streams x positions at level 1, ``launches``,
``fused``) and ``demucs.lstm`` (``hops``, ``rows``: streams, ``launches``);
``launches`` counts the ``rowmm`` and LSTM kernels launched inside
(``profiling.counted_span``), ``fused`` the launches of ``rowmm``'s fused
entry among them.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from .. import profiling
from ..constants import FRAME_LENGTH
from ..ops.kernels import lstm, overlap, rowmm
from ..ops.kernels.rowmm import matmul
from .base import ParamModule, Placeholder, constant_on, num_params, param

domain = "waveform"

DEFAULT_CONFIG = {
    "kind": "demucs",
    "chin": 1,
    "chout": 1,
    "hidden": 64,
    "depth": 5,
    "kernel_size": 8,
    "stride": 4,
    "causal": True,
    "resample": 4,
    "growth": 2,
    "max_hidden": 10000,
    "normalize": True,
    "glu": True,
    "floor": 1e-3,
    "rescale": 0.1,
    "lstm_layers": 2,
    "delay_hops": 3,
    "compute_dtype": "bfloat16",
    "init_seed": 0,
}

ZEROS = 56                  # the resampler's zero crossings a side
TAPS = 2 * ZEROS            # its FIR's taps
KERNEL, STRIDE = 8, 4
# activation bytes a block of hops may hold on a device: sizes the block
BLOCK_BYTES = 8 << 30


def resolve(config: Dict[str, Any] = None) -> Dict[str, Any]:
    """The config over the defaults, checked: what this port takes of
    denoiser's settings (the strides and the resampling make the 256-sample
    hop; the channel widths and the LSTM depth are free)."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    for key, want in (("chin", 1), ("chout", 1), ("depth", 5), ("kernel_size", KERNEL),
                      ("stride", STRIDE), ("causal", True), ("resample", 4),
                      ("normalize", True), ("glu", True)):
        if cfg[key] != want:
            raise ValueError("demucs: %s %r is not supported (only %r)" % (key, cfg[key], want))
    if cfg["compute_dtype"] not in ("bfloat16", "float32"):
        raise ValueError("demucs: compute_dtype %r" % cfg["compute_dtype"])
    if int(cfg["delay_hops"]) < 3:
        raise ValueError("demucs: delay_hops %r is below the model's lookahead (3 hops)"
                         % cfg["delay_hops"])
    return cfg


def delay_hops(config: Dict[str, Any] = None) -> int:
    """Hops between an input hop and the output hop that it completes."""
    return int(resolve(config)["delay_hops"])


def channels(cfg) -> List[int]:
    """C_0 .. C_depth: the input's channels, then each encoder level's."""
    ch, h = [cfg["chin"]], cfg["hidden"]
    for _ in range(cfg["depth"]):
        ch.append(h)
        h = min(int(cfg["growth"] * h), cfg["max_hidden"])
    return ch


class Layout(NamedTuple):
    """Positions a hop and lags of each stage (``layout``)."""
    per_hop: Tuple[int, ...]      # P_k: positions a hop at level k (0: u at 64 kHz)
    enc_carry: Tuple[int, ...]    # [k]: input positions encoder level k carries (k >= 1)
    enc_lag: Tuple[int, ...]      # [k]: e_k's lag behind the input, in its positions
    dec_lag: Tuple[int, ...]      # [k]: d_k's lag
    skip: Tuple[int, ...]         # [k]: positions of e_k waiting for d_k
    z1_lag: int                   # the first downsampler's output's lag (32 kHz)
    out_pairs: int                # pairs the last downsampler carries


@functools.lru_cache(maxsize=None)
def layout(depth: int, delay: int) -> Layout:
    """The fixed pipeline: a stage whose input lags lag_in positions emits
    every output whose window is complete, so its output lags
    ceil((lag_in + 4) / 4) and it carries 4 lag_out - lag_in input positions;
    a transposed convolution's output lags 4x its input's."""
    per_hop = tuple(FRAME_LENGTH * 4 // STRIDE ** k for k in range(depth + 1))
    enc_lag = [2 * (2 * ZEROS) + 2 * ZEROS]            # u: 2 x 112 + 112 at 64 kHz
    enc_carry = [0]
    for _ in range(depth):
        lag = -(-(enc_lag[-1] + 4) // 4)
        enc_carry.append(4 * lag - enc_lag[-1])
        enc_lag.append(lag)
    dec_lag = [0] * (depth + 1)
    dec_lag[depth] = enc_lag[depth]
    for k in range(depth, 0, -1):
        dec_lag[k - 1] = 4 * dec_lag[k]
    skip = tuple(dec_lag[k] - enc_lag[k] for k in range(depth + 1))
    for k in range(1, depth):
        if skip[k] < enc_carry[k + 1]:
            raise ValueError("demucs: skip %d holds less than encoder level %d's carry"
                             % (k, k + 1))
    z1_lag = dec_lag[0] // 2 + ZEROS
    out_pairs = FRAME_LENGTH * delay - (z1_lag // 2 - ZEROS)
    if out_pairs < TAPS - 1:
        raise ValueError("demucs: delay %d hops is below the model's lookahead" % delay)
    return Layout(per_hop, tuple(enc_carry), tuple(enc_lag), tuple(dec_lag), skip, z1_lag,
                  out_pairs)


def _layout(cfg) -> Layout:
    return layout(cfg["depth"], int(cfg["delay_hops"]))


def resample_kernel() -> np.ndarray:
    """denoiser's ``kernel_upsample2(56)`` (also its downsampler's), [112, 1]
    f32: sinc(pi t) x the odd samples of a 225-point symmetric Hann window,
    t = -55.5 .. 55.5, made in float64."""
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(4 * ZEROS + 1) / (4 * ZEROS))
    t = np.linspace(-ZEROS + 0.5, ZEROS - 0.5, TAPS) * np.pi
    return (np.sin(t) / t * win[1::2]).astype(np.float32).reshape(TAPS, 1)


class Conv(nn.Module):
    """A Conv1d's or ConvTranspose1d's weight and bias, PyTorch's layouts
    ([out, in, K] and [in, out, K])."""

    def __init__(self, t):
        super().__init__()
        self.weight, self.bias = param(t["weight"]), param(t["bias"])


class Level(nn.Module):
    """``encoder.{k}`` or ``decoder.{k}``: its two layers with weights, named
    by their places in denoiser's nn.Sequential ("0" and "2")."""

    def __init__(self, t):
        super().__init__()
        for name in ("0", "2"):
            self.add_module(name, Conv(t[name]))


class LSTMWeights(nn.Module):
    """``nn.LSTM``'s weight_ih_l{n} [4H, in], weight_hh_l{n} [4H, H],
    bias_ih_l{n}, bias_hh_l{n} [4H]; gates i, f, g, o."""

    def __init__(self, t):
        super().__init__()
        for name, v in t.items():
            setattr(self, name, param(v))


class BLSTM(nn.Module):
    """denoiser's ``BLSTM`` of a causal model: the LSTM and no linear layer."""

    def __init__(self, t):
        super().__init__()
        self.lstm = LSTMWeights(t["lstm"])


class Demucs(ParamModule):
    """Parameters of the model, denoiser's ``state_dict`` names
    (``encoder/0/0/weight`` -> ``encoder.0.0.weight``)."""

    def __init__(self, tree):
        super().__init__()
        self.encoder = nn.ModuleList(Level(t) for t in tree["encoder"])
        self.decoder = nn.ModuleList(Level(t) for t in tree["decoder"])
        self.lstm = BLSTM(tree["lstm"])

    def operand(self, name: str, dtype: str):
        """A product's right operand as ``rowmm`` takes it, [K, N] rounded to
        the compute dtype and held as f32: ``enc{k}`` (level k's strided
        convolution, rows tap-major: [8 C_{k-1}, C_k]), ``enc{k}.1x1``,
        ``dec{k}.1x1`` ([C_k, 2 C_k]), the same as ``enc{k}.glu`` and
        ``dec{k}.glu`` with their columns in ``rowmm.pair_glu``'s order (the
        fused entry's GLU), and ``dec{k}.t`` (the transposed convolution,
        [C_k, 8 C_{k-1}], columns tap-major)."""
        level, _, part = name.partition(".")
        w = self._conv(level, part).weight

        def build():
            if part == "1x1":
                m = w[:, :, 0].t()
            elif part == "glu":
                m = rowmm.pair_glu(w[:, :, 0].t())
            elif part == "t":
                m = w.permute(0, 2, 1).reshape(w.shape[0], -1)
            else:
                m = w.permute(2, 1, 0).reshape(-1, w.shape[0])
            m = m.bfloat16().float() if dtype == "bfloat16" else m
            return m.contiguous()
        return self.derived("%s:%s" % (name, dtype), build)

    def bias(self, name: str) -> torch.Tensor:
        """The bias of ``operand(name)``'s columns (``.glu``: paired too)."""
        level, _, part = name.partition(".")
        b = self._conv(level, part).bias
        if part != "glu":
            return b
        return self.derived("%s:bias" % name, lambda: rowmm.pair_glu(b).contiguous())

    def _conv(self, level: str, part: str) -> Conv:
        """``enc{k}`` or ``dec{k}``'s layer: its 1x1 convolution for part
        ``1x1`` or ``glu``, else its strided or transposed one."""
        k = int(level[3:])
        one = part in ("1x1", "glu")
        if level.startswith("enc"):
            return getattr(self.encoder[k - 1], "2" if one else "0")
        return getattr(self.decoder[len(self.encoder) - k], "0" if one else "2")

    def cell_operands(self, i: int, dtype: str):
        """LSTM layer ``i`` as the cell takes it: bf16, the kernel's (w
        [4H, padded(in) + H] in pass order, b_ih + b_hh); f32, (w [in + H,
        4H], b)."""
        m = self.lstm.lstm
        w_ih, w_hh = getattr(m, "weight_ih_l%d" % i), getattr(m, "weight_hh_l%d" % i)
        b_ih, b_hh = getattr(m, "bias_ih_l%d" % i), getattr(m, "bias_hh_l%d" % i)

        def build():
            if dtype == "bfloat16":
                return lstm.stack_weights(w_ih, w_hh, b_ih, b_hh)
            return torch.cat([w_ih, w_hh], dim=1).t().contiguous(), (b_ih + b_hh).contiguous()
        return self.derived("cell:%d:%s" % (i, dtype), build)


Params = Demucs


def draw(generator: torch.Generator, config: Dict[str, Any] = None):
    """The seeded weights as a tree of f32 CPU tensors, in ``state_dict``
    order: each Conv1d weight and bias uniform in +-1/sqrt(C_in K), each
    ConvTranspose1d's in +-1/sqrt(C_out K) (PyTorch's fan-in of its
    [in, out, K] weight), every LSTM tensor in +-1/sqrt(H); then every
    convolution's weight and bias divided by sqrt(std(weight) / rescale)
    (denoiser's ``rescale_module``)."""
    cfg = resolve(config)
    ch, depth = channels(cfg), cfg["depth"]

    def uniform(shape, fan):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) / math.sqrt(fan)

    def conv(c_out, c_in, k):
        return {"weight": uniform((c_out, c_in, k), c_in * k), "bias": uniform((c_out,), c_in * k)}

    def convt(c_in, c_out, k):
        return {"weight": uniform((c_in, c_out, k), c_out * k),
                "bias": uniform((c_out,), c_out * k)}

    encoder = [{"0": conv(ch[i + 1], ch[i], KERNEL), "2": conv(2 * ch[i + 1], ch[i + 1], 1)}
               for i in range(depth)]
    decoder = [{"0": conv(2 * ch[i + 1], ch[i + 1], 1), "2": convt(ch[i + 1], ch[i], KERNEL)}
               for i in reversed(range(depth))]
    for level in encoder + decoder:
        for layer in level.values():
            scale = (layer["weight"].std() / cfg["rescale"]) ** 0.5
            layer["weight"] = layer["weight"] / scale
            layer["bias"] = layer["bias"] / scale
    hid = ch[-1]
    cells = {}
    for i in range(cfg["lstm_layers"]):
        cells["weight_ih_l%d" % i] = uniform((4 * hid, hid), hid)
        cells["weight_hh_l%d" % i] = uniform((4 * hid, hid), hid)
        cells["bias_ih_l%d" % i] = uniform((4 * hid,), hid)
        cells["bias_hh_l%d" % i] = uniform((4 * hid,), hid)
    return {"encoder": encoder, "decoder": decoder, "lstm": {"lstm": cells}}


def init_params(generator: torch.Generator, config: Dict[str, Any] = None) -> Demucs:
    """Fresh weights (``draw``) from a CPU generator."""
    return Demucs(draw(generator, config))


def params_from_tree(tree, config: Dict[str, Any] = None) -> Demucs:
    """A model file's tree: its weights, or, where it holds only the
    weightless placeholder, the weights drawn from its config's
    ``init_seed``."""
    if set(tree) == set(Placeholder().state_dict()):
        return init_params(torch.Generator().manual_seed(int(resolve(config)["init_seed"])),
                           config)
    return Demucs(tree)


def normalize_config(config: Dict[str, Any], tree=None) -> Dict[str, Any]:
    """A model file's config, checked and over the defaults."""
    return resolve(config)


def init_state(batch_shape: Tuple[int, ...], config: Dict[str, Any], device):
    cfg = resolve(config)
    lay, ch = _layout(cfg), channels(cfg)
    lead, dev = tuple(batch_shape), torch.device(device)

    def zeros(*shape):
        return torch.zeros(lead + shape, device=dev)

    state = {"resample_in": zeros(TAPS - 1), "resample_up": zeros(TAPS - 1),
             "enc_in": zeros(lay.enc_carry[1] * ch[0]),
             "resample_down": zeros(2 * TAPS), "resample_out": zeros(2 * lay.out_pairs),
             "lstm_h": zeros(cfg["lstm_layers"], ch[-1]),
             "lstm_c": zeros(cfg["lstm_layers"], ch[-1]),
             "ms_sum": zeros(), "count": zeros(), "scales": zeros(int(cfg["delay_hops"]))}
    for k in range(1, cfg["depth"]):
        state["skip%d" % k] = zeros(lay.skip[k], ch[k])
    for k in range(1, cfg["depth"] + 1):
        state["overlap%d" % k] = zeros(KERNEL - STRIDE, ch[k - 1])
    return state


def _tail(key: str) -> int:
    """Axes of a state leaf past the batch axes."""
    if key in ("ms_sum", "count"):
        return 0
    if key.startswith(("skip", "overlap", "lstm")):
        return 2
    return 1


def _flat(state, n: int):
    return {k: v.reshape((n,) + v.shape[v.dim() - _tail(k):]) for k, v in state.items()}


def _unflat(state, lead):
    return {k: v.reshape(lead + v.shape[v.dim() - _tail(k):]) for k, v in state.items()}


def _ones(n: int) -> np.ndarray:
    return np.ones((n, 1), np.float32)


def _rounder(dtype: str):
    return (lambda t: t.bfloat16().float()) if dtype == "bfloat16" else (lambda t: t)


def _fir(win: torch.Tensor, n: int) -> torch.Tensor:
    """The resampler's FIR over a carried window [rows, n + 111 + ...]: the
    first n outputs, each a fixed-order f32 product of 112 taps."""
    taps = win.unfold(-1, TAPS, 1)[:, :n]                  # a row-strided view
    return matmul(taps, constant_on(resample_kernel, win.device))[..., 0]


def _upsample(sig: torch.Tensor, carry: torch.Tensor):
    """denoiser's ``upsample2`` on the stream: sig [rows, L] new samples,
    carry [rows, 111] those before -> ([rows, 2L] samples lagging 56 input
    samples, the new carry). Sample p -> (x[p], sum_m x[p - 55 + m] k[m])."""
    n = sig.shape[1]
    win = torch.cat([carry, sig], dim=1)
    odd = _fir(win, n)
    out = torch.stack([win[:, ZEROS - 1:ZEROS - 1 + n], odd], dim=-1).reshape(sig.shape[0], 2 * n)
    return out, win[:, n:].clone()


def _downsample(sig: torch.Tensor, carry: torch.Tensor):
    """denoiser's ``downsample2`` on the stream: sig [rows, 2L] new samples
    (whole pairs), carry [rows, 2c] the c pairs before (c >= 112) -> ([rows,
    L] outputs, starting 56 pairs into the window, the new carry). Output i
    -> 0.5 (x[2i] + sum_m x[2(i - 56 + m) + 1] k[m])."""
    n = sig.shape[1] // 2
    win = torch.cat([carry, sig], dim=1)
    odd = win[:, 1:2 * (n + TAPS - 1):2].contiguous()
    out = (win[:, 2 * ZEROS:2 * (ZEROS + n):2] + _fir(odd, n)) * 0.5
    return out, win[:, 2 * n:].clone()


def _head_mask(x: torch.Tensor, count: torch.Tensor, per_hop: int, lag: int) -> None:
    """Zero, in place, the positions of x [rows, T P, ...] before the
    stream's start: position P n - lag + i of block hop j (n = count + j)."""
    hops = min(x.shape[1] // per_hop, -(-lag // per_hop))
    head = x[:, :hops * per_hop].unflatten(1, (hops, per_hop))
    j = torch.arange(hops, device=x.device, dtype=torch.float32)
    i = torch.arange(per_hop, device=x.device, dtype=torch.float32)
    pos = per_hop * (count[:, None, None] + j[None, :, None]) - lag + i[None, None, :]
    keep = (pos >= 0).float()
    head.mul_(keep.reshape(keep.shape + (1,) * (head.dim() - 3)))


def _glu(z: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """GLU over the last axis, z [..., 2C] -> out [..., C] (z's second half
    is overwritten)."""
    c = z.shape[-1] // 2
    return torch.mul(z[..., :c], z[..., c:].sigmoid_(), out=out)


def _conv_window(win: torch.Tensor, n_out: int) -> torch.Tensor:
    """A window [rows, 4 n_out + 4.., C] -> its n_out frames [rows, n_out, 8 C]:
    frame i is positions 4i .. 4i + 7, a row-strided view."""
    c = win.shape[2] if win.dim() == 3 else 1
    return win.as_strided((win.shape[0], n_out, KERNEL * c), (win.stride(0), STRIDE * c, 1))


def _glu_1x1(params: Demucs, level: str, a: torch.Tensor, dtype: str, round_out: bool,
             out: torch.Tensor) -> torch.Tensor:
    """``level``'s 1x1 convolution and GLU of a [rows, n, C], into out
    [rows, n, C] (rounded where round_out): ``rowmm.fused``'s GLU over the
    paired operand ``{level}.glu`` where C is a multiple of
    ``rowmm.GLU_BLOCK`` (every level of dns64), else, at the small widths
    that pairing does not take, the fused entry's bias over ``{level}.1x1``
    and the GLU and rounding as PyTorch ops (the same bits)."""
    if out.shape[-1] % rowmm.GLU_BLOCK == 0:
        return rowmm.fused(a, params.operand(level + ".glu", dtype), params.bias(level + ".glu"),
                           glu=True, round_out=round_out, out=out)
    z = rowmm.fused(a, params.operand(level + ".1x1", dtype), params.bias(level + ".1x1"))
    g = _glu(z, torch.empty_like(out))
    return out.copy_(_rounder(dtype)(g) if round_out else g)


def _encoder(params: Demucs, st, new, u, count, cfg):
    """u [rows, 1024 T] -> the skips of levels 1 .. depth-1 (buffers [rows,
    skip_k + P_k T, C_k], the carry first) and e_depth [rows, T, C_depth].
    Each level is two calls of ``rowmm.fused``: the strided convolution
    reads its window over the f32 input (u, or the skip buffer) rounded on
    load and stores ReLU(. + bias) rounded, the next product's operand; the
    1x1 convolution's GLU goes straight into the skip buffer (f32)."""
    lay, ch = _layout(cfg), channels(cfg)
    dtype, depth, rows = cfg["compute_dtype"], cfg["depth"], u.shape[0]
    bf16 = dtype == "bfloat16"
    t_len = u.shape[1] // lay.per_hop[0]
    win = torch.cat([st["enc_in"], u], dim=1)
    new["enc_in"] = win[:, win.shape[1] - lay.enc_carry[1]:].clone()
    skips = {}
    for k in range(1, depth + 1):
        n_out = lay.per_hop[k] * t_len
        h = rowmm.fused(_conv_window(win, n_out), params.operand("enc%d" % k, dtype),
                        params.bias("enc%d" % k), relu=True, round_a=bf16, round_out=bf16)
        if k == depth:
            return skips, _glu_1x1(params, "enc%d" % k, h, dtype, False,
                                   torch.empty((rows, n_out, ch[k]), device=u.device))
        keep = lay.skip[k]
        buf = torch.empty((rows, keep + n_out, ch[k]), device=u.device)
        buf[:, :keep] = st["skip%d" % k]
        _glu_1x1(params, "enc%d" % k, h, dtype, False, buf[:, keep:])
        skips[k] = buf
        new["skip%d" % k] = buf[:, n_out:].clone()
        win = buf[:, keep - lay.enc_carry[k + 1]:]


def _encoder_plain(params: Demucs, st, new, u, count, cfg):
    """Plain version of ``_encoder``: each product through ``rowmm`` on an
    operand rounded by its own pass, then the bias, ReLU, rounding and GLU
    as PyTorch ops (the same bits)."""
    lay, ch, rnd = _layout(cfg), channels(cfg), _rounder(cfg["compute_dtype"])
    dtype, depth, rows = cfg["compute_dtype"], cfg["depth"], u.shape[0]
    t_len = u.shape[1] // lay.per_hop[0]
    win = torch.cat([st["enc_in"], u], dim=1)
    new["enc_in"] = win[:, win.shape[1] - lay.enc_carry[1]:].clone()
    skips = {}
    for k in range(1, depth + 1):
        n_out = lay.per_hop[k] * t_len
        frames = _conv_window(rnd(win), n_out)
        z = matmul(frames, params.operand("enc%d" % k, dtype)).add_(params.bias("enc%d" % k))
        z = matmul(rnd(z.relu_()), params.operand("enc%d.1x1" % k, dtype))
        z.add_(params.bias("enc%d.1x1" % k))
        if k == depth:
            return skips, _glu(z, torch.empty((rows, n_out, ch[k]), device=u.device))
        keep = lay.skip[k]
        buf = torch.empty((rows, keep + n_out, ch[k]), device=u.device)
        buf[:, :keep] = st["skip%d" % k]
        _glu(z, buf[:, keep:])
        skips[k] = buf
        new["skip%d" % k] = buf[:, n_out:].clone()
        win = buf[:, keep - lay.enc_carry[k + 1]:]


def _cell(params: Demucs, i: int, x, h, c, h_new, c_new, dtype: str) -> None:
    w, b = params.cell_operands(i, dtype)
    if dtype == "bfloat16":
        lstm.lstm_cell(x, h, c, w, b, h_new, c_new)
        return
    gates = matmul(torch.cat([x, h], dim=-1), w) + b
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    c_new.copy_(torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg))
    h_new.copy_(torch.sigmoid(go) * torch.tanh(c_new))


def _lstm(params: Demucs, st, new, e, count, cfg):
    """The LSTM over the block's bottleneck frames e [rows, T, H], one hop
    at a time; a frame before the stream's start (hops 0 and 1) leaves the
    state at zero. -> d [rows, T, H]."""
    lag = _layout(cfg).enc_lag[cfg["depth"]]
    h, c = st["lstm_h"], st["lstm_c"]
    d = torch.empty_like(e)
    for j in range(e.shape[1]):
        h_new, c_new = torch.empty_like(h), torch.empty_like(c)
        x = e[:, j]
        for i in range(h.shape[1]):
            _cell(params, i, x, h[:, i], c[:, i], h_new[:, i], c_new[:, i], cfg["compute_dtype"])
            x = h_new[:, i]
        if j < lag:
            keep = (count + j >= lag).float()[:, None, None]
            h_new.mul_(keep)
            c_new.mul_(keep)
        d[:, j] = h_new[:, -1]
        h, c = h_new, c_new
    new["lstm_h"], new["lstm_c"] = h, c
    return d


def _head_glu(g: torch.Tensor, count: torch.Tensor, k: int, t_len: int, lay: Layout) -> None:
    """Zero, in place, each 1x1 output g [rows, P_k T, C] whose transposed
    convolution's overlap would reach the stream's position 0 from position
    -1: a stream's first ``before`` hops lie before position 0 at level k,
    and the last position of its hop before - 1 is no context of position 0."""
    per_hop = lay.per_hop[k]
    before = lay.dec_lag[k] // per_hop
    for j in range(min(t_len, before)):
        g[:, per_hop * (j + 1) - 1].mul_((count + j != before - 1).float()[:, None])


def _decoder(params: Demucs, st, new, d, skips, e_last, count, cfg):
    """d_depth [rows, T, C] -> d_0 [rows, 1024 T]. Each level is the 1x1
    convolution's GLU through ``rowmm.fused`` (stored rounded, the
    transposed convolution's operand), the transposed convolution through
    ``rowmm`` and ``overlap.overlap_add``, which also adds the bias, ReLU and
    the next level's skip, and stores the next 1x1 product's operand rounded.
    (A value's mask by 0 or 1 commutes with its rounding.)"""
    lay, ch, rnd = _layout(cfg), channels(cfg), _rounder(cfg["compute_dtype"])
    dtype, depth, rows = cfg["compute_dtype"], cfg["depth"], d.shape[0]
    bf16 = dtype == "bfloat16"
    t_len = d.shape[1] // lay.per_hop[depth]
    a = rnd(d.add_(e_last))
    for k in range(depth, 0, -1):
        n_in, c_out = lay.per_hop[k] * t_len, ch[k - 1]
        g = _glu_1x1(params, "dec%d" % k, a, dtype, bf16,
                     torch.empty((rows, n_in, ch[k]), device=d.device))
        _head_glu(g, count, k, t_len, lay)
        p = matmul(g, params.operand("dec%d.t" % k, dtype))
        a, new["overlap%d" % k] = overlap.overlap_add(
            p.view(rows, n_in, 2, KERNEL - STRIDE, c_out), st["overlap%d" % k],
            params.bias("dec%d.t" % k), relu=k > 1,
            skip=skips[k - 1][:, :n_in * STRIDE] if k > 1 else None, round_out=bf16 and k > 1)
    return a.view(rows, -1)


def _decoder_plain(params: Demucs, st, new, d, skips, e_last, count, cfg):
    """Plain version of ``_decoder``: the products through ``rowmm`` on
    operands rounded by their own passes, GLU, the overlap-add, bias, ReLU
    and skip adds as PyTorch ops (the same bits)."""
    lay, ch, rnd = _layout(cfg), channels(cfg), _rounder(cfg["compute_dtype"])
    dtype, depth, rows = cfg["compute_dtype"], cfg["depth"], d.shape[0]
    t_len = d.shape[1] // lay.per_hop[depth]
    for k in range(depth, 0, -1):
        n_in, c_out = lay.per_hop[k] * t_len, ch[k - 1]
        d.add_(e_last if k == depth else skips[k][:, :n_in])
        z = matmul(rnd(d), params.operand("dec%d.1x1" % k, dtype))
        g = _glu(z.add_(params.bias("dec%d.1x1" % k)),
                 torch.empty((rows, n_in, ch[k]), device=d.device))
        _head_glu(g, count, k, t_len, lay)
        p = matmul(rnd(g), params.operand("dec%d.t" % k, dtype))
        p = p.view(rows, n_in, 2, KERNEL - STRIDE, c_out)
        out = torch.empty((rows, n_in, KERNEL - STRIDE, c_out), device=d.device)
        torch.add(p[:, 1:, 0], p[:, :-1, 1], out=out[:, 1:])
        torch.add(p[:, 0, 0], st["overlap%d" % k], out=out[:, 0])
        new["overlap%d" % k] = p[:, -1, 1].clone()
        out.add_(params.bias("dec%d.t" % k))
        if k > 1:
            out.relu_()
        d = out.view(rows, n_in * STRIDE, c_out)
    return d.view(rows, -1)


@contextlib.contextmanager
def _counted(name: str, fused: bool = False, **counts):
    """``profiling.counted_span`` over the ``rowmm`` and LSTM launch counters
    (count ``launches``); with ``fused``, also the launches of ``rowmm``'s
    fused entry among them (count ``fused``)."""
    before = rowmm.fused_launches
    with profiling.counted_span(name, lambda: rowmm.launches + lstm.launches, **counts) as s:
        yield s
        if fused and s is not None:
            s.counts["fused"] = rowmm.fused_launches - before


def _scale(st, hops: torch.Tensor):
    """The scale of each hop of a block, [n, T], and the running sum after
    it: a fixed-order mean square a hop, the running sum hop by hop."""
    t_len, dev = hops.shape[1], hops.device
    ms = matmul(hops * hops, constant_on(_ones, dev, FRAME_LENGTH))[..., 0] / FRAME_LENGTH
    run = torch.empty_like(ms)
    acc = st["ms_sum"]
    for j in range(t_len):
        acc = torch.add(acc, ms[:, j], out=run[:, j])
    seen = st["count"][:, None] + torch.arange(1, t_len + 1, device=dev, dtype=torch.float32)
    return torch.sqrt(run / seen), run[:, -1].clone()


def _block(params: Demucs, st, hops: torch.Tensor, out: torch.Tensor, cfg) -> Dict:
    """One block of T hops of n streams: state (batch axis n) and hops [n, T,
    256] -> state'; the output hops go into out [n, T, 256]."""
    lay, depth = _layout(cfg), cfg["depth"]
    rows, t_len = hops.shape[:2]
    count = st["count"]
    new = {}
    with _counted("demucs.resample", hops=t_len):
        scale, new["ms_sum"] = _scale(st, hops)
        new["count"] = count + t_len
        scales = torch.cat([st["scales"], scale], dim=1)
        new["scales"] = scales[:, t_len:].clone()
        x = (hops / (cfg["floor"] + scale)[..., None]).reshape(rows, -1)
        y1, new["resample_in"] = _upsample(x, st["resample_in"])
        _head_mask(y1, count, 2 * FRAME_LENGTH, 2 * ZEROS)
        u, new["resample_up"] = _upsample(y1, st["resample_up"])
    with _counted("demucs.encoder", fused=True, hops=t_len, rows=rows * lay.per_hop[1] * t_len):
        skips, e_last = _encoder(params, st, new, u, count, cfg)
    with _counted("demucs.lstm", hops=t_len, rows=rows):
        d = _lstm(params, st, new, e_last, count, cfg)
    with _counted("demucs.decoder", fused=True, hops=t_len, rows=rows * lay.per_hop[1] * t_len):
        d0 = _decoder(params, st, new, d, skips, e_last, count, cfg)
    with _counted("demucs.resample", hops=t_len):
        _head_mask(d0, count, lay.per_hop[0], lay.dec_lag[0])
        z1, new["resample_down"] = _downsample(d0, st["resample_down"])
        _head_mask(z1, count, 2 * FRAME_LENGTH, lay.z1_lag)
        y, new["resample_out"] = _downsample(z1, st["resample_out"])
        torch.mul(y.view(rows, t_len, FRAME_LENGTH), scales[:, :t_len, None], out=out)
    return new


def block_hops(rows: int, cfg) -> int:
    """Hops a block takes at ``rows`` streams: as many as keep about eight
    level-1 activations of each (a level's product, its rounded operand, the
    1x1 product's two halves, the skip and the next window) within
    BLOCK_BYTES."""
    per_hop = 8 * channels(cfg)[1] * _layout(cfg).per_hop[1] * 4
    return max(1, BLOCK_BYTES // max(1, rows * per_hop))


def apply_sequence(params: Demucs, state, hops: torch.Tensor, config: Dict[str, Any] = None):
    """Sequence mode: hops [*, T, 256] -> (final state, output hops [*, T,
    256]), in blocks of ``block_hops`` hops, each level over every hop of a
    block at once."""
    cfg = resolve(config)
    lead, t_len = hops.shape[:-2], hops.shape[-2]
    n = int(np.prod(lead, dtype=np.int64))
    x = hops.reshape(n, t_len, FRAME_LENGTH)
    st = _flat(state, n)
    out = torch.empty_like(x)
    step_hops = block_hops(n, cfg)
    for lo in range(0, t_len, step_hops):
        hi = min(t_len, lo + step_hops)
        st = _block(params, st, x[:, lo:hi], out[:, lo:hi], cfg)
    return _unflat(st, lead), out.reshape(hops.shape)


def step(params: Demucs, state, hop: torch.Tensor, config: Dict[str, Any] = None):
    """Single-hop step: (state, hop [*, 256]) -> (state', output hop [*, 256])."""
    st, out = apply_sequence(params, state, hop.unsqueeze(-2), config)
    return st, out.squeeze(-2)


__all__ = ["DEFAULT_CONFIG", "Demucs", "Params", "domain", "resolve", "delay_hops", "channels",
           "layout", "resample_kernel", "draw", "init_params", "params_from_tree",
           "normalize_config", "init_state", "step", "apply_sequence", "block_hops", "num_params"]
