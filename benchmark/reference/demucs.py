"""Plain reference of the `demucs` model kind over whole streams.

Demucs, causal, as denoiser's `dns64` (Défossez, Synnaeve and Adi,
Interspeech 2020, arXiv:2006.12847; github.com/facebookresearch/denoiser),
offline over each whole stream, then delayed by `delay_hops` hops:

    s_r    = sqrt(mean over hops 0..r of mean(x_hop^2))     a hop's scale
    u      = upsample2(upsample2(x_r / (floor + s_r)))      16 -> 64 kHz
    e_k    = glu(conv1x1(relu(conv(e_{k-1}, K 8, stride 4))))   k = 1..5, no padding
    d_5    = LSTM(e_5), 2 layers, from zeros
    d_{k-1} = conv_transpose(glu(conv1x1(d_k + e_k)), K 8, stride 4), relu but the last
    y_r    = s_r * downsample2(downsample2(d_0)) at hop r
    out_t  = y_{t - 3} (zeros for t < 3)

`upsample2` interleaves x with conv1d(x, k, padding=56)[1:]; `downsample2`
is 0.5 (x_even + conv1d(x_odd, k, padding=56)[:-1]); k is denoiser's
112-tap windowed sinc. The signals are channels first, as PyTorch's
convolutions hold them; a convolution is its windows (`unfold`) times the
weight, a transposed convolution the weight's product scattered into the
output at stride 4. Every convolution's product takes its operands in
`products` precision with float32 sums; the resampling FIRs in `resample`
precision. Everything else is float32.

Weights: the model file's, or, where it holds only the placeholder, drawn
from its config's `init_seed` (`draw`): PyTorch's default initialisation
and denoiser's `rescale_module`, in `state_dict` order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .stft import HOP, prod

ZEROS = 56


def sinc_kernel() -> torch.Tensor:
    """denoiser's kernel_upsample2(56): [112] float32, made in float64."""
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(4 * ZEROS + 1) / (4 * ZEROS))
    t = np.linspace(-ZEROS + 0.5, ZEROS - 0.5, 2 * ZEROS) * np.pi
    return torch.as_tensor((np.sin(t) / t * win[1::2]).astype(np.float32))


def widths(cfg):
    ch, h = [cfg["chin"]], cfg["hidden"]
    for _ in range(cfg["depth"]):
        ch.append(h)
        h = min(int(cfg["growth"] * h), cfg["max_hidden"])
    return ch


def draw(cfg):
    """{state_dict name: float32 CPU tensor} from `init_seed`: uniform in
    +-1/sqrt(fan_in) (a Conv1d's C_in K, a ConvTranspose1d's C_out K, the
    LSTM's H), drawn in state_dict order from one generator; then each
    convolution divided by sqrt(std(weight) / rescale)."""
    g = torch.Generator().manual_seed(int(cfg["init_seed"]))
    ch, depth, kern = widths(cfg), cfg["depth"], cfg["kernel_size"]
    out = {}

    def uni(name, shape, fan):
        out[name] = (torch.rand(shape, generator=g) * 2.0 - 1.0) / math.sqrt(fan)

    convs = []
    for i in range(depth):
        uni("encoder.%d.0.weight" % i, (ch[i + 1], ch[i], kern), ch[i] * kern)
        uni("encoder.%d.0.bias" % i, (ch[i + 1],), ch[i] * kern)
        uni("encoder.%d.2.weight" % i, (2 * ch[i + 1], ch[i + 1], 1), ch[i + 1])
        uni("encoder.%d.2.bias" % i, (2 * ch[i + 1],), ch[i + 1])
        convs += ["encoder.%d.0" % i, "encoder.%d.2" % i]
    for j in range(depth):
        i = depth - 1 - j
        uni("decoder.%d.0.weight" % j, (2 * ch[i + 1], ch[i + 1], 1), ch[i + 1])
        uni("decoder.%d.0.bias" % j, (2 * ch[i + 1],), ch[i + 1])
        uni("decoder.%d.2.weight" % j, (ch[i + 1], ch[i], kern), ch[i] * kern)
        uni("decoder.%d.2.bias" % j, (ch[i],), ch[i] * kern)
        convs += ["decoder.%d.0" % j, "decoder.%d.2" % j]
    for name in convs:
        scale = (out[name + ".weight"].std() / cfg["rescale"]) ** 0.5
        out[name + ".weight"] = out[name + ".weight"] / scale
        out[name + ".bias"] = out[name + ".bias"] / scale
    hid = ch[-1]
    for n in range(cfg["lstm_layers"]):
        for k, shape in (("weight_ih", (4 * hid, hid)), ("weight_hh", (4 * hid, hid)),
                         ("bias_ih", (4 * hid,)), ("bias_hh", (4 * hid,))):
            uni("lstm.lstm.%s_l%d" % (k, n), shape, hid)
    return out


def fir(x: torch.Tensor, k: torch.Tensor, dtype: str) -> torch.Tensor:
    """conv1d(x, k, padding=56) over the last axis, [..., L] -> [..., L + 1]."""
    xp = F.pad(x, (ZEROS, ZEROS))
    return prod(xp.unfold(-1, 2 * ZEROS, 1), k[:, None], dtype)[..., 0]


def upsample2(x, k, dtype):
    out = fir(x, k, dtype)[..., 1:]
    return torch.stack([x, out], dim=-1).flatten(-2)


def downsample2(x, k, dtype):
    even, odd = x[..., ::2], x[..., 1::2]
    return (even + fir(odd, k, dtype)[..., :-1]) * 0.5


def conv(x, w, b, stride, dtype):
    """x [B, C_in, L] -> [B, C_out, (L - K) / stride + 1] (no padding)."""
    c_out, c_in, kern = w.shape
    win = x.unfold(-1, kern, stride).permute(0, 2, 1, 3).reshape(x.shape[0], -1, c_in * kern)
    return (prod(win, w.reshape(c_out, c_in * kern).t(), dtype) + b).transpose(1, 2)


def conv_transpose(x, w, b, stride, dtype):
    """x [B, C_in, L] -> [B, C_out, (L - 1) stride + K]."""
    c_in, c_out, kern = w.shape
    n, length = x.shape[0], x.shape[-1]
    y = prod(x.transpose(1, 2), w.reshape(c_in, c_out * kern), dtype).reshape(n, length, c_out,
                                                                               kern)
    out = torch.zeros((n, c_out, (length - 1) * stride + kern), device=x.device)
    for k in range(kern):
        out[:, :, k:k + stride * length:stride] += y[..., k].transpose(1, 2)
    return out + b[:, None]


def glu(z):
    return F.glu(z, dim=1)


class Weights:
    """The model's tensors on a device (float32), by state_dict name."""

    def __init__(self, flat, config, device):
        self.cfg = dict(config)
        if set(flat) == {"empty"}:
            tensors = draw(self.cfg)
        else:
            tensors = {k.replace("/", "."): torch.as_tensor(v) for k, v in flat.items()}
        self.t = {k: v.to(device) for k, v in tensors.items()}
        self.kernel = sinc_kernel().to(device)


@torch.no_grad()
def enhance(w: Weights, hops: torch.Tensor, product: str, resample: str) -> torch.Tensor:
    """hops [B, T, 256] float32 of fresh streams -> enhanced hops [B, T, 256]."""
    cfg, t = w.cfg, w.t
    b, t_len = hops.shape[:2]
    depth, delay = cfg["depth"], int(cfg["delay_hops"])
    ms = (hops * hops).mean(dim=-1)
    scale = torch.sqrt(torch.cumsum(ms, dim=1) /
                       torch.arange(1, t_len + 1, device=hops.device, dtype=torch.float32))
    x = (hops / (cfg["floor"] + scale[..., None])).reshape(b, 1, -1)
    x = F.pad(x, (0, 4 * HOP))          # past the stream: changes no compared output
    x = upsample2(upsample2(x, w.kernel, resample), w.kernel, resample)
    skips = []
    for i in range(depth):
        p = "encoder.%d." % i
        x = torch.relu(conv(x, t[p + "0.weight"], t[p + "0.bias"], cfg["stride"], product))
        x = glu(conv(x, t[p + "2.weight"], t[p + "2.bias"], 1, product))
        skips.append(x)
    hid = x.shape[1]
    h = [torch.zeros(b, hid, device=x.device) for _ in range(cfg["lstm_layers"])]
    c = [torch.zeros(b, hid, device=x.device) for _ in range(cfg["lstm_layers"])]
    frames = []
    for f in range(x.shape[-1]):
        v = x[..., f]
        for n in range(cfg["lstm_layers"]):
            p = "lstm.lstm.%s_l%d"
            gates = (prod(v, t[p % ("weight_ih", n)].t(), product) + t[p % ("bias_ih", n)]
                     + prod(h[n], t[p % ("weight_hh", n)].t(), product) + t[p % ("bias_hh", n)])
            gi, gf, gg, go = gates.chunk(4, dim=-1)
            c[n] = torch.sigmoid(gf) * c[n] + torch.sigmoid(gi) * torch.tanh(gg)
            h[n] = torch.sigmoid(go) * torch.tanh(c[n])
            v = h[n]
        frames.append(v)
    x = torch.stack(frames, dim=-1)
    for j in range(depth):
        skip = skips.pop()
        n = min(x.shape[-1], skip.shape[-1])
        x = x[..., :n] + skip[..., :n]
        p = "decoder.%d." % j
        x = glu(conv(x, t[p + "0.weight"], t[p + "0.bias"], 1, product))
        x = conv_transpose(x, t[p + "2.weight"], t[p + "2.bias"], cfg["stride"], product)
        if j < depth - 1:
            x = torch.relu(x)
    y = downsample2(downsample2(x[:, 0], w.kernel, resample), w.kernel, resample)
    y = y[:, :(t_len - delay) * HOP].reshape(b, -1, HOP) * scale[:, :t_len - delay, None]
    return torch.cat([torch.zeros((b, delay, HOP), device=hops.device), y], dim=1)


class Reference:
    """The model of a configuration (its model file, read by `pv`)."""

    def __init__(self, config, model_path, device):
        from .pv import read_pv
        flat, file_cfg = read_pv(model_path)
        self.weights = Weights(flat, dict(file_cfg, **config["model"]), device)

    def enhance(self, hops, precision, fused_hops=0):
        """`precision`: {"products", "resample"}; no hop takes a fused path."""
        return enhance(self.weights, hops, precision["products"], precision["resample"])
