"""KoalaNet in PyTorch: the frame-wise GRU spectral-mask estimator.

The same model as the JAX package's ``models/mask_gru.py``, on the same
weights:

    features [*, enc_in] (log-magnitude | posterior SNR | floor level | cepstral peaks)
      -> Dense(enc_in -> H) + gelu (tanh form)
      -> L x GRU(H) with residual adds
      -> Dense(H -> 257) + sigmoid, blended toward 1 by a scalar passthrough gate

Products run as the JAX package's ``_mm``: both operands rounded to the
compute dtype (bfloat16), products summed in float32. ``torch.matmul`` on
bf16 tensors would round its output to bf16 too, so the operands are
rounded and multiplied as float32 instead.

``apply_sequence`` keeps the JAX branch structure. The kernel branch runs
the floor tracker (ops/kernels/floor.py) and the GRU stack
(ops/kernels/gru.py); the scan branch steps through T in plain PyTorch. The
branch follows the tensor's device: CUDA takes the kernels, the CPU the scan
(as the JAX package on its CPU backend). ``use_pallas=True`` forces the
kernel branch (on the CPU through the kernels' plain versions), ``False``
the scan. Within the kernel branch the GRU stack takes its kernel wherever
``plan_launch`` has a launch plan for the shape (on an H100, every stack that
the JAX package's kernel takes, and more); elsewhere it runs the scan, with
one warning, as the JAX package does where its kernel does not fit. The
kernels take one batch axis: on the kernel branch an unbatched input (one
stream's ``Koala.enhance``) gets a batch of one, and a batch of several axes
is flattened to one, for the recurrences only.

Training: parameters are created frozen (inference never builds a graph);
a trainer calls ``requires_grad_(True)`` on the module. Under grad mode the
weights are then rounded live instead of through the detached cache, the
stacked GRU operands are built live so that their gradient reaches every
layer, and the kernel branch runs the differentiable wrappers
(``floor_scan_trainable``, ``gru_stack_trainable``). The scan branch is
plain autograd.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..constants import NUM_BINS
from ..ops.kernels.floor import floor_scan, floor_scan_ref, floor_scan_trainable
from ..ops.kernels.gru import H100_SMS, gru_stack, gru_stack_trainable, plan_launch

logger = logging.getLogger("koala_tpu_torch")

DEFAULT_CONFIG = {
    "kind": "mask_gru",
    "hidden": 384,
    "num_layers": 2,
    "bins": NUM_BINS,
    "feat_eps": 1e-4,
    "feat_scale": 0.25,
    "feat_shift": 1.5,
    # noise-floor tracker (opt-in; legacy model files have it off)
    "snr_bands": 0,
    "floor_rise": 0.012,
    "snr_scale": 0.2,
    "snr_clip": 4.0,
    "floor_feat": False,
    # cepstral-peak harmonicity features (opt-in)
    "cep_feats": 0,
    "cep_scale": 2.0,
    "compute_dtype": "bfloat16",
    # "auto": kernel branch on CUDA tensors; True: always; False: never
    "use_pallas": "auto",
}

# The configuration new models are trained with (tracker + cepstral features).
TRAIN_CONFIG = dict(DEFAULT_CONFIG, snr_bands=32, floor_feat=True, cep_feats=8)


def expected_enc_in(cfg: Dict[str, Any]) -> int:
    """Encoder fan-in implied by a config's feature switches."""
    nb = cfg.get("snr_bands") or 0
    return (cfg["bins"] + nb * (2 if cfg.get("floor_feat") else 1)
            + (cfg.get("cep_feats") or 0))


def normalize_config(config: Dict[str, Any], params=None) -> Dict[str, Any]:
    """Resolve a (possibly legacy, partial) saved config against defaults and,
    given ``params`` (a tree of arrays), reconcile the feature switches with
    the encoder weight's fan-in."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    if params is None:
        return cfg
    enc_in = int(np.shape(params["enc"]["w"])[0])
    if enc_in == expected_enc_in(cfg):
        return cfg
    for snr_bands, floor_feat, cep in ((0, False, 0), (32, False, 0),
                                       (32, True, 0), (32, True, 8)):
        trial = dict(cfg, snr_bands=snr_bands, floor_feat=floor_feat,
                     cep_feats=cep)
        if enc_in == expected_enc_in(trial):
            return trial
    raise ValueError(
        "model file encoder fan-in %d matches no known feature layout "
        "(bins=%d, config %r)" % (enc_in, cfg["bins"], config))


def _param(a) -> nn.Parameter:
    if isinstance(a, torch.Tensor):
        return nn.Parameter(a.detach().float().clone(), requires_grad=False)
    return nn.Parameter(torch.tensor(np.asarray(a, np.float32)), requires_grad=False)


def init_params(generator: torch.Generator, config: Dict[str, Any] = None) -> "MaskGRU":
    """Fresh weights on the generator's device: uniform +-1/sqrt(fan_in),
    zero biases, the decoder bias at +3 (an untrained model is a
    near-passthrough), the gate closed (w = 0, b = -2). Same distribution as
    the JAX package's ``init_params``, not the same numbers."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    h, layers, bins = cfg["hidden"], cfg["num_layers"], cfg["bins"]
    dev = generator.device

    def uniform(fan_in, fan_out):
        scale = 1.0 / np.sqrt(fan_in)
        return (torch.rand((fan_in, fan_out), generator=generator, device=dev) * 2.0 - 1.0) * scale

    def zeros(n, fill=0.0):
        return torch.full((n,), fill, device=dev)

    tree = {
        "enc": {"w": uniform(expected_enc_in(cfg), h), "b": zeros(h)},
        "gru": [{"wx": uniform(h, 3 * h), "wh": uniform(h, 3 * h),
                 "bx": zeros(3 * h), "bh": zeros(3 * h)} for _ in range(layers)],
        "dec": {"w": uniform(h, bins), "b": zeros(bins, 3.0)},
        "gate": {"w": torch.zeros((h, 1), device=dev), "b": zeros(1, -2.0)},
    }
    return MaskGRU(tree)


def _records_graph(*sources: torch.Tensor) -> bool:
    """The one test of "derive live or from the cache": grad mode is on and
    one of the tensors the result is derived from takes a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in sources)


class Dense(nn.Module):
    """w [in, out], b [out] (the JAX tree's {"w", "b"})."""

    def __init__(self, w, b):
        super().__init__()
        self.w = _param(w)
        self.b = _param(b)


class GRULayer(nn.Module):
    """wx, wh [H, 3H] and bx, bh [3H], gate columns in z, r, n order."""

    def __init__(self, wx, bx, wh, bh):
        super().__init__()
        self.wx, self.bx = _param(wx), _param(bx)
        self.wh, self.bh = _param(wh), _param(bh)


class MaskGRU(nn.Module):
    """Parameters of the mask model. ``state_dict`` keys map one to one onto
    the ``.pv`` flat names (``gru/0/wx`` -> ``gru.0.wx``)."""

    def __init__(self, tree):
        super().__init__()
        self.enc = Dense(tree["enc"]["w"], tree["enc"]["b"])
        self.gru = nn.ModuleList(
            GRULayer(l["wx"], l["bx"], l["wh"], l["bh"]) for l in tree["gru"])
        self.dec = Dense(tree["dec"]["w"], tree["dec"]["b"])
        # the passthrough gate is optional: pre-gate model files have none
        self.gate = Dense(tree["gate"]["w"], tree["gate"]["b"]) if "gate" in tree else None
        self._derived: Dict[str, Tuple[Any, Any]] = {}

    def derived(self, name: str, build):
        """A tensor derived from the weights (a bf16 copy, a stacked or padded
        layout), built once and rebuilt when a weight changes or moves."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        hit = self._derived.get(name)
        if hit is None or hit[0] != key:
            # a plain tensor without a graph: usable in a graph recorded later
            # (inference_mode(False) alone would switch grad mode on)
            with torch.inference_mode(False), torch.no_grad():
                hit = (key, build())
            self._derived[name] = hit
        return hit[1]

    def rounded(self, name: str, cfg) -> torch.Tensor:
        """Weight ``name`` (a dotted state_dict key) rounded to the compute
        dtype, held as float32 (the right operand of ``_mm``). Cached for
        inference; rounded live when a graph is recorded (the gradient passes
        through the cast)."""
        w = self.get_parameter(name)
        if cfg.get("compute_dtype") != "bfloat16":
            return w
        if _records_graph(w):
            return w.bfloat16().float()
        return self.derived("round:" + name, lambda: w.detach().bfloat16().float())

    def training_graph(self) -> bool:
        """True when a forward pass must record a graph to the weights."""
        return _records_graph(*self.parameters())

    def gru_stacked(self):
        """(wx, bx, wh, bh) stacked over layers: [L,H,3H] bf16 and [L,3H] f32,
        the GRU kernel's operands. Cached for inference; built live when a
        graph is recorded (a cached tensor would carry one optimizer step's
        graph into the next)."""
        def build():
            return (torch.stack([l.wx for l in self.gru]).bfloat16().contiguous(),
                    torch.stack([l.bx for l in self.gru]).contiguous(),
                    torch.stack([l.wh for l in self.gru]).bfloat16().contiguous(),
                    torch.stack([l.bh for l in self.gru]).contiguous())
        if _records_graph(*self.gru.parameters()):
            return build()
        return self.derived("gru_stacked", build)


def num_params(params: MaskGRU) -> int:
    """The number of parameters of a model (every weight and bias)."""
    return sum(p.numel() for p in params.parameters())


def _mm(x, params: MaskGRU, name: str, cfg):
    """Model product in the configured compute dtype, f32 sums."""
    if cfg.get("compute_dtype") == "bfloat16":
        x = x.bfloat16()
    return torch.matmul(x.float(), params.rounded(name, cfg))


def features(re, im, cfg):
    """Spectrum -> model input features: scaled log-magnitude."""
    mag = torch.sqrt(re * re + im * im + cfg["feat_eps"] ** 2)
    return (torch.log(mag) + cfg["feat_shift"]) * cfg["feat_scale"]


@functools.lru_cache(maxsize=8)
def _band_matrix_np(bins: int, nb: int):
    """[bins, nb] mel-spaced contiguous averaging pools (fixed, not learned)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    hz = 700.0 * (10.0 ** (np.linspace(0.0, hz_to_mel(8000.0), nb + 1)
                           / 2595.0) - 1.0)
    edges = np.round(hz / 8000.0 * (bins - 1)).astype(np.int64)
    edges = np.maximum(edges, np.arange(nb + 1))      # ensure distinct groups
    edges[-1] = bins
    m = np.zeros((bins, nb), np.float32)
    for j in range(nb):
        lo, hi = int(edges[j]), int(edges[j + 1])
        m[lo:hi, j] = 1.0 / max(hi - lo, 1)
    return m


@functools.lru_cache(maxsize=8)
def _cep_matrix_np(bins: int, nb: int):
    """([bins, n_lags] real-cepstrum basis over pitch lags 40..200, and the
    contiguous lag-index slices of the ``nb`` group maxima)."""
    lags = np.arange(40, 201)
    k = np.arange(bins)[:, None].astype(np.float64)
    w = np.full((bins, 1), 2.0 / 512.0)
    w[0] = w[-1] = 1.0 / 512.0
    basis = (w * np.cos(2.0 * np.pi * k * lags[None, :] / 512.0)).astype(np.float32)
    edges = np.round(40.0 * (200.0 / 40.0) ** (np.arange(nb + 1) / nb)
                     ).astype(np.int64)
    bounds = tuple((int(edges[g] - 40), int(edges[g + 1] - 40 + 1))
                   for g in range(nb))
    return basis, bounds


@functools.lru_cache(maxsize=16)
def _constant_on(name: str, bins: int, nb: int, device: torch.device):
    # made outside inference mode, so that a constant first asked for by a
    # serving call can enter a graph that a trainer records later
    with torch.inference_mode(False):
        if name == "band":
            return torch.as_tensor(_band_matrix_np(bins, nb), device=device)
        return torch.as_tensor(_cep_matrix_np(bins, nb)[0], device=device)


def cep_features(re, im, cfg):
    """Spectrum [*, K] -> cepstral-peak features [*, cep_feats]."""
    nb = cfg["cep_feats"]
    basis = _constant_on("cep", cfg["bins"], nb, re.device)
    _, bounds = _cep_matrix_np(cfg["bins"], nb)
    logmag = 0.5 * torch.log(re * re + im * im + cfg["feat_eps"] ** 2)
    c = torch.matmul(logmag, basis)
    gmax = torch.stack([c[..., lo:hi].amax(dim=-1) for lo, hi in bounds], dim=-1)
    return torch.clamp(gmax * cfg["cep_scale"], -1.0, 4.0)


def band_log_energy(re, im, cfg):
    """Spectrum [*, K] -> banded log-energy [*, nb] (floor-tracker domain)."""
    m = _constant_on("band", cfg["bins"], cfg["snr_bands"], re.device)
    e = torch.matmul(re * re + im * im, m)
    return torch.log(e + cfg["feat_eps"] ** 2)


def _floor_update(floor, lb, cfg):
    """One frame of minimum-statistics tracking (float32 throughout; ties
    take the first argument)."""
    return torch.minimum(floor + cfg["floor_rise"], lb)


def _snr_features(lb, floor, cfg):
    snr = torch.clamp((lb - floor) * cfg["snr_scale"], 0.0, cfg["snr_clip"])
    if not cfg.get("floor_feat"):
        return snr
    lvl = (floor + 9.0) * 0.15
    return torch.cat([snr, lvl], dim=-1)


def _mask_head(params: MaskGRU, x, cfg):
    """Decoder mask + scalar passthrough gate."""
    mask = torch.sigmoid(_mm(x, params, "dec.w", cfg) + params.dec.b)
    if params.gate is not None:
        g = torch.sigmoid(_mm(x, params, "gate.w", cfg) + params.gate.b)
        mask = mask + g * (1.0 - mask)
    return mask


def _gru_recurrent(params: MaskGRU, i: int, h, xproj, cfg):
    """One GRU step of layer ``i`` given xproj = x @ wx + bx."""
    hproj = _mm(h, params, "gru.%d.wh" % i, cfg) + params.gru[i].bh
    xz, xr, xn = xproj.chunk(3, dim=-1)
    hz, hr, hn = hproj.chunk(3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def init_state(batch_shape: Tuple[int, ...], config: Dict[str, Any], device):
    """Fresh state, batch dims leading: h [*, L, H] zeros and, with the
    tracker, floor [*, nb] at 30.0 (above any real signal, so the first
    frame's minimum claims it)."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    h = torch.zeros(tuple(batch_shape) + (cfg["num_layers"], cfg["hidden"]),
                    device=torch.device(device))
    nb = cfg.get("snr_bands") or 0
    if not nb:
        return h
    return {"h": h, "floor": torch.full(tuple(batch_shape) + (nb,), 30.0,
                                        device=torch.device(device))}


def _feat(x, cfg):
    """Feature groups are cast to the compute dtype before the concat; the
    encoder product rounds to it anyway, so this is exact."""
    return x.bfloat16() if cfg.get("compute_dtype") == "bfloat16" else x


def _kernel_branch(cfg, t: torch.Tensor) -> bool:
    mode = cfg.get("use_pallas")
    if mode in (False, None):
        return False
    return mode is True or t.device.type == "cuda"


_FALLBACK_WARNED: set = set()


def _warn_fallback(reason: str, cfg) -> bool:
    """Say loudly (once per reason and shape) that the card runs the scan
    branch instead of the kernels."""
    key = (reason, cfg.get("num_layers"), cfg.get("hidden"))
    if key not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(key)
        logger.warning("mask_gru: GRU kernel DISABLED (%s; layers=%s hidden=%s) - "
                       "sequence mode falls back to the scan branch",
                       reason, cfg.get("num_layers"), cfg.get("hidden"))
    return False


def gru_kernel_fits(batch: int, hidden: int, layers: int, sms: int) -> bool:
    """Whether the GRU kernel has a launch plan (``plan_launch``, memoised)
    for [batch, hidden] x ``layers`` on a card of ``sms`` SMs: False where no
    cut into layer groups fits a row group's blocks onto the card and a
    block's share of the weights and operands into its shared memory."""
    try:
        plan_launch(batch, hidden, layers, sms=sms)
    except ValueError:
        return False
    return True


def _rows(x) -> int:
    """Rows of the one batch axis that the kernels see for x [*, T, C]: the
    product of the batch axes, 1 for an unbatched input."""
    return int(np.prod(x.shape[:-2], dtype=np.int64))


def _gru_kernel_enabled(cfg, x) -> bool:
    """The kernel branch's GRU gate, as the JAX package's ``_pallas_enabled``:
    where the kernel cannot take the shape, warn once and run the scan
    branch. On the CPU (the kernels' plain versions) it asks the plan of an
    H100, so that the CPU takes the branch the card would take."""
    if not _kernel_branch(cfg, x):
        return False
    if cfg.get("compute_dtype") != "bfloat16":
        return _warn_fallback("compute_dtype != bfloat16", cfg)
    if cfg["hidden"] % 16:
        return _warn_fallback("hidden not a multiple of 16", cfg)
    sms = (torch.cuda.get_device_properties(x.device).multi_processor_count
           if x.device.type == "cuda" else H100_SMS)
    # the plan depends on the batch only through how rows are laid out, so
    # one warning stands for every batch of this width and depth
    if not gru_kernel_fits(_rows(x), cfg["hidden"], cfg["num_layers"], sms):
        return _warn_fallback("no GRU kernel launch plan", cfg)
    return True


def step(params: MaskGRU, state, re, im, config: Dict[str, Any] = None):
    """Single-frame step: (state, [*, K] spectrum) -> (state', mask [*, K])."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    nb = cfg.get("snr_bands") or 0
    x = _feat(features(re, im, cfg), cfg)
    if nb:
        lb = band_log_energy(re, im, cfg)
        floor = _floor_update(state["floor"], lb, cfg)
        x = torch.cat([x, _feat(_snr_features(lb, floor, cfg), cfg)], dim=-1)
        hstate = state["h"]
    else:
        hstate = state
    if cfg.get("cep_feats"):
        x = torch.cat([x, _feat(cep_features(re, im, cfg), cfg)], dim=-1)
    x = F.gelu(_mm(x, params, "enc.w", cfg) + params.enc.b, approximate="tanh")
    new_states = []
    for i, layer in enumerate(params.gru):
        xproj = _mm(x, params, "gru.%d.wx" % i, cfg) + layer.bx
        h = _gru_recurrent(params, i, hstate[..., i, :], xproj, cfg)
        new_states.append(h)
        x = x + h
    mask = _mask_head(params, x, cfg)
    h_new = torch.stack(new_states, dim=-2)
    return ({"h": h_new, "floor": floor} if nb else h_new), mask


def apply_sequence(params: MaskGRU, state, re, im, config: Dict[str, Any] = None):
    """Sequence mode: spectra [*, T, K] -> (final_state, masks [*, T, K]).
    Frame-local work (features, encoder, input projections, decoder) runs
    over all T at once; only the recurrences step through T."""
    cfg = dict(DEFAULT_CONFIG, **(config or {}))
    nb = cfg.get("snr_bands") or 0
    x = _feat(features(re, im, cfg), cfg)                       # [*, T, K]
    if nb:
        lb = band_log_energy(re, im, cfg)                       # [*, T, nb]
        t_ax = lb.dim() - 2
        lb_t = lb.movedim(t_ax, 0)                              # [T, *, nb]
        if _kernel_branch(cfg, lb_t):
            scan = floor_scan_trainable if params.training_graph() else floor_scan
            floor_final, floors = scan(
                state["floor"].reshape(-1, nb).contiguous(),     # [B, nb]
                lb_t.reshape(lb_t.shape[0], -1, nb).contiguous(),  # [T, B, nb]
                float(cfg["floor_rise"]))
            floor_final = floor_final.reshape(state["floor"].shape)
            floors = floors.reshape(lb_t.shape)
        else:
            floor_final, floors = floor_scan_ref(state["floor"], lb_t, cfg["floor_rise"])
        snr = _feat(_snr_features(lb_t, floors, cfg), cfg)
        x = torch.cat([x, snr.movedim(0, t_ax)], dim=-1)
        state = state["h"]
    if cfg.get("cep_feats"):
        x = torch.cat([x, _feat(cep_features(re, im, cfg), cfg)], dim=-1)
    x = F.gelu(_mm(x, params, "enc.w", cfg) + params.enc.b, approximate="tanh")

    if _gru_kernel_enabled(cfg, x):
        wx, bx, wh, bh = params.gru_stacked()
        stack = gru_stack_trainable if params.training_graph() else gru_stack
        lead = x.shape[:-2]
        y, h_final = stack(
            state.reshape((-1,) + state.shape[-2:]).movedim(1, 0).contiguous(),  # [L, B, H]
            x.reshape((-1,) + x.shape[-2:]).movedim(1, 0).bfloat16().contiguous(),  # [T, B, H]
            wx, bx, wh, bh)
        x = y.movedim(0, 1).reshape(lead + x.shape[-2:])        # [*, T, H]
        state = h_final.movedim(0, 1).reshape(lead + state.shape[-2:])   # [*, L, H]
        if nb:
            state = {"h": state, "floor": floor_final}
        return state, _mask_head(params, x, cfg)

    t_axis = x.dim() - 2
    new_h = []
    for i, layer in enumerate(params.gru):
        xproj = _mm(x, params, "gru.%d.wx" % i, cfg) + layer.bx   # [*, T, 3H]
        h = state[..., i, :]
        hs = []
        for t in range(xproj.shape[t_axis]):
            h = _gru_recurrent(params, i, h, xproj.select(t_axis, t), cfg)
            hs.append(h)
        new_h.append(h)
        if hs:
            x = x + torch.stack(hs, dim=t_axis)
    state = torch.stack(new_h, dim=-2)
    if nb:
        state = {"h": state, "floor": floor_final}
    return state, _mask_head(params, x, cfg)


__all__ = [
    "DEFAULT_CONFIG", "TRAIN_CONFIG", "normalize_config", "expected_enc_in",
    "MaskGRU", "init_params", "init_state", "step", "apply_sequence", "features",
    "band_log_energy", "cep_features", "num_params", "gru_kernel_fits",
]
