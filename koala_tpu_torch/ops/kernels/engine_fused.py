"""The whole enhancement engine over T hops: CUDA kernels and plain version.

``fused_sequence`` replaces the JAX package's TPU kernel ``fused_sequence``
(ops/pallas/engine_fused.py:384 -> _fused_call :285 -> _kernel :118). Per
hop of every stream:

    split-K windowed DFT of [carry | hop] -> log-magnitude, band log-energy,
    floor tracker, SNR and floor-level features, 8 cepstral group maxima ->
    encoder + tanh-GELU -> L-layer GRU -> decoder sigmoid mask + passthrough
    gate -> masked inverse DFT -> overlap-add

bf16 product operands with f32 sums everywhere (the DFT bases too), f32
state, the frame carry rounded to bf16 - the TPU kernel's numerics. Compared
with the engine's float32 DFT path the output moves by bf16 spectral
rounding only (tests hold it at >= 35 dB).

Layout (``Layout`` below): the spectrum is computed on the 257 real bins,
padded to KR = 272 (a multiple of the 16-wide tensor-core tile) for re and
KI = 256 for im (the im Nyquist bin is identically zero). Padding columns
carry exact zeros and zero weight rows, so they never reach a real output.

On this card the least time is set by the bf16 products (operations), and
two thirds of them are the GRU's, whose steps depend on each other. So the
chain is split by its dependences (csrc/engine_fused.cu): the frame-local
work (DFT, features, band and cepstral products, encoder; decoder, mask,
inverse DFT) runs as tiled tensor-core products over all B x T frames at
once on every SM, the floor tracker as the stand-alone ``floor_scan``'s
kernel, the GRU as ``gru_stack``'s kernel with ``plan_launch``'s plan, and
the two shifts between neighbouring hops are indexing. One call of the C
entry is five launches back to back: front, floor, encode, GRU, back. What
passes between them lies in a workspace that scales with B x T
(``frame_bytes``), so long inputs are walked in segments of whole hops under
``WORKSPACE_BYTES``, with the state carried between two segments exactly as
between two calls.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ... import profiling
from ...constants import FFT_SIZE, FRAME_LENGTH, NUM_BINS
from ...models.mask_gru import _band_matrix_np, _cep_matrix_np
from ...models.registry import kind_of
from ..stft import _windowed_bases
from . import _build
from .gru import layers_step, plan_launch

T_BLOCK = 8        # sequence_fast runs whole multiples of this through the kernel
KR = 272           # re bins, 257 padded to a multiple of 16
KI = 256           # im bins 0..255 (the Nyquist bin's im is identically 0)
KS = KR + KI       # spectrum width
MAX_CEP = 8
SMEM_LIMIT = 232448   # dynamic shared memory one block may use on Hopper
# Most bytes of workspace that one segment of a call may take (a constant of
# the design, not a knob): 468 hops at B = 64, so a 6 s batch is one segment.
WORKSPACE_BYTES = 128 * 2 ** 20
STAGES = ("front", "floor", "encode", "gru", "back")

# calls of ``fused_sequence`` that launched the kernels since the last reset,
# and the device launches they made: five per segment (plain integers)
launches = 0
device_launches = 0


def _ceil16(n: int) -> int:
    return (n + 15) // 16 * 16


class Layout:
    """Widths of the kernel's operands for one configuration."""

    def __init__(self, cfg):
        self.nb = cfg["snr_bands"]
        self.nbp = _ceil16(self.nb)
        self.cep = cfg.get("cep_feats") or 0
        self.lagp = _ceil16(161)
        self.enc_in = KR + 2 * self.nbp
        self.decn = KR + 16            # decoder columns + one tile for the gate
        self.hidden = cfg["hidden"]
        self.layers = cfg["num_layers"]


def frame_bytes(hidden: int, nbp: int) -> int:
    """Workspace bytes per frame (one hop of one stream): the f32 spectrum,
    the bf16 feature, lb and floors, the cepstral maxima, x and y."""
    return KS * 4 + KR * 2 + 2 * nbp * 4 + MAX_CEP * 4 + 2 * hidden * 2


def segment_hops(batch: int, per_frame: int, budget: int = WORKSPACE_BYTES) -> int:
    """Hops of one segment: as many whole hops of ``batch`` streams as
    ``budget`` bytes of workspace hold, and never fewer than one. The port
    always takes the default ``budget``; tests give smaller ones."""
    return max(1, budget // (batch * per_frame))


def fused_sequence_supported(cfg, batch: int, t_len: int, device) -> bool:
    """Shape/config gate for the fused engine kernels on ``device``. Any
    batch >= 1 and any T >= 1 are taken; the conditions are what the stages'
    layout needs. On a card the GRU stage must also have a launch plan
    (``plan_launch``) and the widest stage's block must fit the shared
    memory, as the CUDA source lays it out; the CPU's plain version has no
    such limits."""
    if kind_of(cfg) != "mask_gru":
        return False
    if cfg.get("bins", NUM_BINS) != NUM_BINS:
        return False
    if not cfg.get("snr_bands") or not cfg.get("floor_feat"):
        return False
    if (cfg.get("cep_feats") or 0) > MAX_CEP:
        return False
    if cfg.get("compute_dtype") != "bfloat16":
        return False
    if cfg["hidden"] % 16 != 0 or cfg["num_layers"] < 1:
        return False
    if batch < 1 or t_len < 1:
        return False
    if torch.device(device).type != "cuda":
        return True
    try:
        plan_launch(batch, cfg["hidden"], cfg["num_layers"],
                    sms=torch.cuda.get_device_properties(device).multi_processor_count)
    except ValueError:
        return False
    smem = _build.library().koala_engine_fused_smem(_ceil16(cfg["snr_bands"]), cfg["hidden"])
    return smem <= SMEM_LIMIT


def _cfg_key(cfg) -> str:
    return repr(sorted((k, v) for k, v in cfg.items()
                       if isinstance(v, (int, float, str, bool))))


def prepare(params, cfg) -> Dict[str, Any]:
    """The kernel's operand set, derived from the model's weights (cached on
    the parameter module): bases and weights in bf16 in the padded layout,
    biases and the cepstral rank-1 rows in f32."""
    def build():
        lay = Layout(cfg)
        dev = params.enc.w.device
        bins, nb, h = cfg["bins"], lay.nb, lay.hidden
        fwd, inv_re, inv_im = _windowed_bases(FFT_SIZE)     # [512,514], [257,512] x2
        fwd_p = np.zeros((FFT_SIZE, KS), np.float32)
        fwd_p[:, :bins] = fwd[:, :bins]
        fwd_p[:, KR:KR + KI] = fwd[:, bins:bins + KI]
        inv_p = np.zeros((KS, FFT_SIZE), np.float32)
        inv_p[:bins] = inv_re
        inv_p[KR:KR + KI] = inv_im[:KI]
        band = np.zeros((KR, lay.nbp), np.float32)
        band[:bins, :nb] = _band_matrix_np(bins, nb)
        cepb = np.zeros((KR, lay.lagp), np.float32)
        bounds = ()
        if lay.cep:
            basis, bounds = _cep_matrix_np(bins, lay.cep)
            cepb[:bins, :basis.shape[1]] = basis
        enc_w = params.enc.w.detach().float().cpu().numpy()
        wenc = np.zeros((lay.enc_in, h), np.float32)
        wenc[:bins] = enc_w[:bins]
        wenc[KR:KR + nb] = enc_w[bins:bins + nb]
        wenc[KR + lay.nbp:KR + lay.nbp + nb] = enc_w[bins + nb:bins + 2 * nb]
        wcep = np.zeros((max(lay.cep, 1), h), np.float32)
        wcep[:lay.cep] = enc_w[bins + 2 * nb:bins + 2 * nb + lay.cep]
        wdec = np.zeros((h, lay.decn), np.float32)
        wdec[:, :bins] = params.dec.w.detach().float().cpu().numpy()
        # padded mask columns: bias -30 (sigmoid ~ 0); their re/im are 0
        bdec = np.full((lay.decn,), -30.0, np.float32)
        bdec[:bins] = params.dec.b.detach().float().cpu().numpy()
        wdec[:, KR] = params.gate.w.detach().float().cpu().numpy()[:, 0]
        bdec[KR] = float(params.gate.b.detach().float().cpu().numpy()[0])

        def bf(a):
            return torch.as_tensor(a, device=dev).bfloat16().contiguous()

        def f32(a):
            return torch.as_tensor(a, device=dev).float().contiguous()

        wx, bx, wh, bh = params.gru_stacked()
        return {"fwd": bf(fwd_p), "inv": bf(inv_p), "band": bf(band), "cepb": bf(cepb),
                "wenc": bf(wenc), "benc": params.enc.b.detach().float().contiguous(),
                "wcep": f32(wcep), "wdec": bf(wdec), "bdec": f32(bdec),
                "wx": wx, "bx": bx, "wh": wh, "bh": bh, "bounds": bounds,
                "layout": lay}
    return params.derived("fused:" + _cfg_key(cfg), build)


def bound(params, cfg, b: int, t_len: int):
    """Least time (ms) of the fused engine over hops [b, t_len, 256] on an
    H100 (``profiling.bound``): by bytes (hops in, out, the state both ways,
    the weights once) and by operations (bf16 products on the tensor cores,
    the f32 elementwise work beside them), at the function's real widths,
    not the kernel's padded ones: 257 bins (514 re|im DFT columns), nb
    bands, 161 cepstral lags, the encoder's bins + 2 nb + cep inputs, 257
    mask columns + the gate."""
    ops = prepare(params, cfg)
    lay = ops["layout"]
    h, L = lay.hidden, lay.layers
    w_bytes = sum(ops[n].numel() * ops[n].element_size() for n in (
        "fwd", "inv", "band", "cepb", "wenc", "benc", "wcep", "wdec", "bdec",
        "wx", "bx", "wh", "bh"))
    s_bytes = b * (256 * 4 + 2 * 256 * 4 + 2 * lay.nb * 4 + 2 * L * h * 4)
    f_bytes = 2 * b * t_len * 256 * 4 + s_bytes + w_bytes
    bins = cfg["bins"]
    enc_in = bins + 2 * lay.nb + lay.cep
    per_row_mm = 2 * (512 * 2 * bins + bins * lay.nb + (bins * 161 if lay.cep else 0) + enc_in * h
                      + L * 2 * h * 3 * h + h * (bins + 1) + 2 * bins * 512)
    per_row_ew = bins * 12 + lay.nb * 12 + lay.cep * (161 + h * 2) + h * 12 \
        + L * h * 20 + bins * 10 + 256 * 2
    return profiling.bound(f_bytes, b * t_len * per_row_mm, b * t_len * per_row_ew)


def _scalars(cfg):
    f32 = np.float32
    return {"eps2": float(f32(cfg["feat_eps"]) ** 2), "rise": float(f32(cfg["floor_rise"])),
            "feat_shift": float(f32(cfg["feat_shift"])),
            "feat_scale": float(f32(cfg["feat_scale"])),
            "snr_scale": float(f32(cfg["snr_scale"])), "snr_clip": float(f32(cfg["snr_clip"])),
            "cep_scale": float(f32(cfg["cep_scale"]))}


def _mmb(a_bf16, w_bf16):
    """bf16 x bf16 product with f32 sums (exact products, f32 accumulation)."""
    return a_bf16.float() @ w_bf16.float()


def fused_sequence_ref(params, state, hops, cfg):
    """Plain version: mirrors the TPU kernel's op order and dtypes
    (the JAX package's ops/pallas/engine_fused.py:408-500) on the layout of
    ``prepare``. (params, state, hops [B,T,256] f32) -> (state', out [B,T,256])."""
    ops = prepare(params, cfg)
    lay = ops["layout"]
    s = _scalars(cfg)
    b = hops.shape[0]
    fwd, inv = ops["fwd"], ops["inv"]
    dftt, dftb = fwd[:FRAME_LENGTH], fwd[FRAME_LENGTH:]
    wenc, wdec = ops["wenc"], ops["wdec"]
    carry = state["input_carry"].bfloat16()
    ola = state["ola"].float()
    floor = torch.full((b, lay.nbp), 30.0, device=hops.device)
    floor[:, :lay.nb] = state["model"]["floor"]
    h = state["model"]["h"].movedim(-2, 0).float()               # [L, B, H]
    hops_bf = hops.bfloat16()
    outs = []
    for t in range(hops.shape[1]):
        hop = hops_bf[:, t, :]
        spec = _mmb(carry, dftt) + _mmb(hop, dftb)
        re, im = spec[:, :KR], spec[:, KR:]
        mag2 = re * re + F.pad(im * im, (0, KR - KI))
        logmag = 0.5 * torch.log(mag2 + s["eps2"])
        feat = (logmag + s["feat_shift"]) * s["feat_scale"]
        lb = torch.log(_mmb(mag2.bfloat16(), ops["band"]) + s["eps2"])
        floor = torch.minimum(floor + s["rise"], lb)
        snr = torch.clamp((lb - floor) * s["snr_scale"], 0.0, s["snr_clip"])
        lvl = (floor + 9.0) * 0.15
        enc = (_mmb(feat.bfloat16(), wenc[:KR])
               + _mmb(snr.bfloat16(), wenc[KR:KR + lay.nbp])
               + _mmb(lvl.bfloat16(), wenc[KR + lay.nbp:])
               + ops["benc"])
        if lay.cep:
            c = _mmb(logmag.bfloat16(), ops["cepb"])
            for g, (lo, hi) in enumerate(ops["bounds"]):
                mg = c[:, lo:hi].amax(dim=1, keepdim=True)
                cg = torch.clamp(mg * s["cep_scale"], -1.0, 4.0)
                enc = enc + cg * ops["wcep"][g][None, :]
        x_f = F.gelu(enc, approximate="tanh")
        h, x_bf = layers_step(h, x_f.bfloat16(), ops["wx"], ops["bx"], ops["wh"], ops["bh"])
        dec = _mmb(x_bf, wdec)
        mask = torch.sigmoid(dec[:, :KR] + ops["bdec"][:KR])
        gate = torch.sigmoid(dec[:, KR:KR + 1] + ops["bdec"][KR])
        mask = mask + gate * (1.0 - mask)
        mre = (re * mask).bfloat16()
        mim = (im * mask[:, :KI]).bfloat16()
        synth = _mmb(mre, inv[:KR]) + _mmb(mim, inv[KR:])
        outs.append(synth[:, :FRAME_LENGTH] + ola)
        ola = synth[:, FRAME_LENGTH:]
        carry = hop
    out = torch.stack(outs, dim=1) if outs else hops.float()
    new_state = {"input_carry": hops[:, -1, :].float(), "ola": ola,
                 "model": {"h": h.movedim(0, -2), "floor": floor[:, :lay.nb]}}
    return new_state, out


class _Args(ctypes.Structure):
    """Mirror of struct FusedArgs in csrc/engine_fused.cu (field for field)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "hops", "carry0", "fwd", "band", "cepb", "wenc", "benc", "wcep", "wx", "bx", "wh",
        "bh", "wdec", "bdec", "inv", "ola0", "floor0", "h0",
        "out", "ola_out", "floor_out", "h_out",
        "spec", "feat", "lb", "floors", "cg", "x", "y", "exch", "counters", "stage_ms",
        "stream")]
        + [(n, ctypes.c_int) for n in (
            "B", "T", "H", "L", "nbp", "cep", "hop_stride", "carry_stride", "out_stride",
            "gru_w", "gru_lg", "gru_rb", "gru_chunks", "gru_groups")]
        + [("cep_lo", ctypes.c_int * MAX_CEP), ("cep_hi", ctypes.c_int * MAX_CEP)]
        + [(n, ctypes.c_float) for n in (
            "eps2", "feat_shift", "feat_scale", "rise", "snr_scale", "snr_clip",
            "cep_scale")])


def fused_sequence(params, state, hops, cfg, stage_ms=None):
    """Fused-engine sequence: (params, engine state, hops [B,T,256] f32) ->
    (state', out [B,T,256] f32), with the engine's state contract. Chunking
    is exact: [0:T1] then [T1:T] equals one [0:T] call bit for bit, and so
    does the walk in segments that keeps the workspace under
    ``WORKSPACE_BYTES``. CPU tensors take the plain version; CUDA tensors
    launch the kernels (or raise). ``stage_ms``: a dict that receives the
    summed milliseconds of each of ``STAGES``. For measurements only: with it
    every segment synchronises with the card before the call goes on.
    Under a profiler the segment walk records the span ``engine.fused``
    (counts ``hops`` and ``segments``; the plain version walks one)."""
    global launches, device_launches
    if hops.device.type == "cpu":
        with profiling.span("engine.fused", hops=hops.shape[-2], segments=1):
            return fused_sequence_ref(params, state, hops, cfg)
    if hops.dim() != 3 or hops.shape[-1] != FRAME_LENGTH:
        raise ValueError("fused_sequence: hops must be [B, T, 256], got %s"
                         % (tuple(hops.shape),))
    b, t_len, _ = hops.shape
    if not fused_sequence_supported(cfg, b, t_len, hops.device):
        raise ValueError("fused_sequence: configuration or shape not supported")
    ops = prepare(params, cfg)
    lay = ops["layout"]
    h, L, nbp = lay.hidden, lay.layers, lay.nbp
    dev = hops.device
    carry = state["input_carry"].float().contiguous()
    ola = state["ola"].float().contiguous()
    floor0 = state["model"]["floor"].float().contiguous()
    h_state = state["model"]["h"].float().contiguous()          # [B, L, H]
    hops = hops.contiguous()
    _build.require_cuda(hops, "fused hops", torch.float32, aligned=True)
    for name, t, shape in (("carry", carry, (b, FRAME_LENGTH)), ("ola", ola, (b, FRAME_LENGTH)),
                           ("floor", floor0, (b, lay.nb)), ("h", h_state, (b, L, h))):
        _build.require_cuda(t, "fused " + name, torch.float32, shape, aligned=True)
    for name in ("fwd", "band", "cepb", "wenc", "wdec", "inv", "wx", "wh"):
        _build.require_cuda(ops[name], "fused " + name, torch.bfloat16, aligned=True)
    for name in ("benc", "wcep", "bdec", "bx", "bh"):
        _build.require_cuda(ops[name], "fused " + name, torch.float32)

    # the kernels' own state layouts: bands padded to nbp at 30, h as [L, B, H]
    floor = torch.full((b, nbp), 30.0, device=dev)
    floor[:, :lay.nb] = floor0
    h_lbh = h_state.movedim(1, 0).contiguous()
    seg = min(t_len, segment_hops(b, frame_bytes(h, nbp)))
    plan = plan_launch(b, h, L, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.barriers(seg) * plan.group_blocks >= 2 ** 32:
        raise ValueError("fused_sequence: a segment of %d hops is too long for one launch" % seg)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def bf(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)

    work = {"spec": f32(b * seg, KS), "feat": bf(b * seg, KR), "lb": f32(seg, b, nbp),
            "floors": f32(seg, b, nbp), "cg": f32(b * seg, MAX_CEP), "x": bf(seg, b, h),
            "y": bf(seg, b, h), "exch": bf(plan.exchange_elems)}
    out = torch.empty_like(hops)
    args = _Args(**{k: ops[k].data_ptr() for k in (
        "fwd", "band", "cepb", "wenc", "benc", "wcep", "wx", "bx", "wh", "bh", "wdec",
        "bdec", "inv")})
    for k, v in work.items():
        setattr(args, k, v.data_ptr())
    args.stream = _build.stream_handle(dev)
    args.B, args.H, args.L, args.nbp, args.cep = b, h, L, nbp, lay.cep
    args.hop_stride = args.out_stride = t_len * FRAME_LENGTH
    args.gru_w, args.gru_lg, args.gru_rb = plan.slice_width, plan.block_layers, plan.chunk_rows
    args.gru_chunks, args.gru_groups = plan.chunks, plan.groups
    for g, (lo, hi) in enumerate(ops["bounds"]):
        args.cep_lo[g], args.cep_hi[g] = lo, hi
    for k, v in _scalars(cfg).items():
        setattr(args, k, v)
    times = (ctypes.c_float * len(STAGES))()
    if stage_ms is not None:
        args.stage_ms = ctypes.addressof(times)
    lib = _build.library()
    starts = range(0, t_len, seg)
    with profiling.span("engine.fused", hops=t_len, segments=len(starts)):
        for start in starts:
            stop = min(t_len, start + seg)
            first = hops[:, start]
            # the hop before the segment: the state's carry, then the input itself
            before = carry if start == 0 else hops[:, start - 1]
            ola_next = torch.empty_like(ola)
            floor_next = torch.empty_like(floor)
            h_next = torch.empty_like(h_lbh)
            counters = torch.zeros(plan.groups, dtype=torch.int32, device=dev)
            args.T = stop - start
            args.hops, args.out = first.data_ptr(), out[:, start].data_ptr()
            args.carry0, args.carry_stride = before.data_ptr(), before.stride(0)
            args.ola0, args.floor0, args.h0 = ola.data_ptr(), floor.data_ptr(), h_lbh.data_ptr()
            args.ola_out, args.floor_out = ola_next.data_ptr(), floor_next.data_ptr()
            args.h_out, args.counters = h_next.data_ptr(), counters.data_ptr()
            # the entry stops at the first stage that fails: a status of 0 is five launches
            _build.check(lib.koala_engine_fused(ctypes.byref(args)), "koala_engine_fused")
            if start == 0:
                launches += 1
            device_launches += len(STAGES)
            if stage_ms is not None:
                for name, ms in zip(STAGES, times):
                    stage_ms[name] = stage_ms.get(name, 0.0) + float(ms)
            ola, floor, h_lbh = ola_next, floor_next, h_next
    new_state = {"input_carry": hops[:, -1, :].clone(), "ola": ola,
                 "model": {"h": h_lbh.movedim(0, 1).contiguous(),
                           "floor": floor[:, :lay.nb].contiguous()}}
    return new_state, out


__all__ = ["fused_sequence", "fused_sequence_ref", "fused_sequence_supported",
           "prepare", "Layout", "T_BLOCK", "frame_bytes", "segment_hops", "WORKSPACE_BYTES",
           "STAGES", "bound"]
