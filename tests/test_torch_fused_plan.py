"""The schedule of the port's fused engine kernels (csrc/engine_fused.cu) as
a plain-torch model, against ``fused_sequence_ref``, and the wrapper's
segment planner.

The kernels run only on a card (tests/test_torch_cuda.py). What is held here
is the design they implement: the chain split by its dependences. All frames'
front end at once in the order m = b T + t (the frame is [hop t-1 | hop t],
hop -1 the carry), the floor tracker as a scan over [T, B, nbp], the encoder
over all frames, ``gru_stack_ref`` over x [T, B, H], the back end over tiles
of 64 consecutive frames that write their last 63 (out[t] = synth[t][:256] +
synth[t-1][256:], a stream's first hop taking ola0), walked in segments with
the state carried as between two calls.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from koala_tpu_torch.models import mask_gru
from koala_tpu_torch.ops.kernels import engine_fused as ef
from koala_tpu_torch.ops.kernels.floor import floor_scan_ref
from koala_tpu_torch.ops.kernels.gru import gru_stack_ref

import torch_ref  # noqa: F401  (pins torch's CPU threads for the whole suite)

CFG = dict(mask_gru.TRAIN_CONFIG, hidden=64, num_layers=2)
KR, KI, FRAME = ef.KR, ef.KI, 256
TILE, TILE_WRITES = 64, 63          # csrc/engine_fused.cu MT, BACK_ROWS
# The model sums each product over all frames in one call where the plain
# version sums a hop at a time; the f32 sums may differ in their last bit.
ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    return mask_gru.init_params(torch.Generator().manual_seed(5), CFG)


def inputs(b, t_len, seed=0):
    """Hops and a state none of whose parts is zero."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0, shift=0.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale + shift).astype(np.float32))

    hops = arr(b, t_len, FRAME, scale=0.05)
    state = {"input_carry": arr(b, FRAME, scale=0.05), "ola": arr(b, FRAME, scale=0.02),
             "model": {"h": arr(b, CFG["num_layers"], CFG["hidden"], scale=0.3),
                       "floor": arr(b, CFG["snr_bands"], scale=0.5, shift=-6.0)}}
    return state, hops


def segment_model(params, state, hops, cfg):
    """One segment, stage by stage as the kernels run it."""
    ops = ef.prepare(params, cfg)
    lay, s = ops["layout"], ef._scalars(cfg)
    b, t_len, _ = hops.shape
    m_all = b * t_len
    mm = ef._mmb

    def t_major(a):                     # [M, w] in the order b T + t -> [T, B, w]
        return a.reshape(b, t_len, -1).transpose(0, 1).contiguous()

    # front: every frame at once
    prev = torch.cat([state["input_carry"].unsqueeze(1), hops[:, :-1]], dim=1)
    frames = torch.cat([prev, hops], dim=2).reshape(m_all, 2 * FRAME).bfloat16()
    spec = mm(frames[:, :FRAME], ops["fwd"][:FRAME]) + mm(frames[:, FRAME:], ops["fwd"][FRAME:])
    re, im = spec[:, :KR], spec[:, KR:]
    mag2 = re * re + F.pad(im * im, (0, KR - KI))
    logmag = 0.5 * torch.log(mag2 + s["eps2"])
    feat = ((logmag + s["feat_shift"]) * s["feat_scale"]).bfloat16()
    lb = t_major(torch.log(mm(mag2.bfloat16(), ops["band"]) + s["eps2"]))
    cg = []
    if lay.cep:
        c = mm(logmag.bfloat16(), ops["cepb"])
        cg = [torch.clamp(c[:, lo:hi].amax(dim=1, keepdim=True) * s["cep_scale"], -1.0, 4.0)
              for lo, hi in ops["bounds"]]
    # floor: sequential in t, bands padded to nbp at 30
    floor0 = torch.full((b, lay.nbp), 30.0)
    floor0[:, :lay.nb] = state["model"]["floor"]
    floor_final, floors = floor_scan_ref(floor0, lb, s["rise"])
    # encode: every frame at once, x in the GRU's [T, B, H]
    lb_m = lb.transpose(0, 1).reshape(m_all, -1)
    fl_m = floors.transpose(0, 1).reshape(m_all, -1)
    snr = torch.clamp((lb_m - fl_m) * s["snr_scale"], 0.0, s["snr_clip"])
    lvl = (fl_m + 9.0) * 0.15
    wenc = ops["wenc"]
    enc = (mm(feat, wenc[:KR]) + mm(snr.bfloat16(), wenc[KR:KR + lay.nbp])
           + mm(lvl.bfloat16(), wenc[KR + lay.nbp:]) + ops["benc"])
    for g, col in enumerate(cg):
        enc = enc + col * ops["wcep"][g][None, :]
    x = t_major(F.gelu(enc, approximate="tanh")).bfloat16()
    # GRU: the stand-alone stack, h as [L, B, H]
    y, h_final = gru_stack_ref(state["model"]["h"].movedim(1, 0), x,
                               ops["wx"], ops["bx"], ops["wh"], ops["bh"])
    y_m = y.transpose(0, 1).reshape(m_all, -1)
    # back: tiles of 64 consecutive frames, the first only a predecessor
    out = torch.full((m_all, FRAME), float("nan"))
    ola_out = torch.full((b, FRAME), float("nan"))
    for m_first in range(-1, m_all - 1, TILE_WRITES):
        rows = [m for m in range(m_first, m_first + TILE) if 0 <= m < m_all]
        dec = mm(y_m[rows], ops["wdec"])
        mask = torch.sigmoid(dec[:, :KR] + ops["bdec"][:KR])
        gate = torch.sigmoid(dec[:, KR:KR + 1] + ops["bdec"][KR])
        mask = mask + gate * (1.0 - mask)
        synth = (mm((re[rows] * mask).bfloat16(), ops["inv"][:KR])
                 + mm((im[rows] * mask[:, :KI]).bfloat16(), ops["inv"][KR:]))
        for i, m in enumerate(rows):
            if m == m_first:
                continue
            bi, t = divmod(m, t_len)
            tail = state["ola"][bi] if t == 0 else synth[i - 1, FRAME:]
            out[m] = synth[i, :FRAME] + tail
            if t == t_len - 1:
                ola_out[bi] = synth[i, FRAME:]
    new_state = {"input_carry": hops[:, -1, :].clone(), "ola": ola_out,
                 "model": {"h": h_final.movedim(0, 1), "floor": floor_final[:, :lay.nb]}}
    return new_state, out.reshape(b, t_len, FRAME)


def schedule_model(params, state, hops, cfg, seg):
    """The wrapper's walk: segments of ``seg`` whole hops."""
    outs = []
    for start in range(0, hops.shape[1], seg):
        state, out = segment_model(params, state, hops[:, start:start + seg], cfg)
        outs.append(out)
    return state, torch.cat(outs, dim=1)


def assert_states_close(got, want, atol):
    assert torch.equal(got["input_carry"], want["input_carry"])
    for a, b in ((got["ola"], want["ola"]), (got["model"]["h"], want["model"]["h"]),
                 (got["model"]["floor"], want["model"]["floor"])):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= atol


@pytest.mark.parametrize("seg", [8, 16])
@pytest.mark.parametrize("t_len", [8, 40])
@pytest.mark.parametrize("b", [3, 17])
def test_schedule_model_matches_plain(params, b, t_len, seg):
    """Output and state within 1e-5 of the plain version, from a state whose
    carry, overlap-add tail, floor and hidden state are all non-zero."""
    state, hops = inputs(b, t_len, seed=b + t_len)
    want_state, want = ef.fused_sequence_ref(params, state, hops, CFG)
    got_state, got = schedule_model(params, state, hops, CFG, seg)
    assert torch.isfinite(got).all()            # every frame written by exactly one tile
    assert (got - want).abs().max().item() <= ATOL
    assert_states_close(got_state, want_state, ATOL)


@pytest.mark.parametrize("b,t_len,cut", [(3, 40, 8), (17, 40, 24), (3, 16, 5)])
def test_schedule_model_is_chunk_exact(params, b, t_len, cut):
    """Two calls with the state handed over, and segments of another length,
    give the bits of one call: no frame's sums depend on where a call starts."""
    state, hops = inputs(b, t_len, seed=7)
    full_state, full = schedule_model(params, state, hops, CFG, t_len)
    mid, head = schedule_model(params, state, hops[:, :cut], CFG, t_len)
    end, tail = schedule_model(params, mid, hops[:, cut:], CFG, t_len)
    seg_state, seg = schedule_model(params, state, hops, CFG, 8)
    for st, out in ((end, torch.cat([head, tail], dim=1)), (seg_state, seg)):
        assert torch.equal(out, full)
        assert_states_close(st, full_state, 0.0)


def test_plain_version_takes_the_same_state(params):
    """The same non-zero state through ``fused_sequence`` on the CPU (the
    plain version) in two calls: the contract the kernels are held to."""
    state, hops = inputs(3, 16, seed=2)
    full_state, full = ef.fused_sequence(params, state, hops, CFG)
    mid, head = ef.fused_sequence(params, state, hops[:, :8], CFG)
    end, tail = ef.fused_sequence(params, mid, hops[:, 8:], CFG)
    assert torch.equal(torch.cat([head, tail], dim=1), full)
    assert_states_close(end, full_state, 0.0)


@pytest.mark.parametrize("batch", [1, 17, 64, 128, 300, 5000, 10 ** 6])
@pytest.mark.parametrize("hidden,nbp", [(384, 32), (64, 32), (128, 48)])
def test_segment_planner(batch, hidden, nbp):
    """Whole hops under the byte budget, as many as fit, never none."""
    per_frame = ef.frame_bytes(hidden, nbp)
    assert per_frame == ef.KS * 4 + ef.KR * 2 + 2 * nbp * 4 + 32 + 4 * hidden
    seg = ef.segment_hops(batch, per_frame)
    assert isinstance(seg, int) and seg >= 1
    if batch * per_frame <= ef.WORKSPACE_BYTES:
        assert seg * batch * per_frame <= ef.WORKSPACE_BYTES < (seg + 1) * batch * per_frame
    else:
        assert seg == 1
    # a smaller budget never gives a longer segment
    assert ef.segment_hops(batch, per_frame, ef.WORKSPACE_BYTES // 2) <= seg


def test_segment_planner_main_shape():
    """The serving shape (B = 64, H = 384, 32 bands: 4480 bytes a frame) runs
    6 s (T = 376) in one segment; B = 128 needs two."""
    per_frame = ef.frame_bytes(384, 32)
    assert per_frame == 4480
    assert ef.segment_hops(64, per_frame) == 468 >= 376
    assert ef.segment_hops(128, per_frame) == 234 < 376
    # the segments of a walk cover every hop once, each of them whole
    for t_len, seg in ((376, 234), (8, 468), (1000, 468)):
        cuts = list(range(0, t_len, seg)) + [t_len]
        assert sum(b - a for a, b in zip(cuts, cuts[1:])) == t_len
        assert all(0 < b - a <= seg for a, b in zip(cuts, cuts[1:]))
