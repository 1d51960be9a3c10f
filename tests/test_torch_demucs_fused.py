"""Demucs's fused U-Net on the CPU: ``rowmm.fused``'s plain version against
the separate ops it stands for, the GLU-paired 1x1 weights against
denoiser's ``state_dict`` layout, the overlap pass's plain version against
the formula elementwise, which fused kernel each of dns64's products takes
on a card, and the fused path (``models/demucs.py`` ``_encoder``,
``_decoder``) against the plain one (``_encoder_plain``, ``_decoder_plain``)
bit for bit, at both precisions."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import audio
from koala_tpu_torch import profiling
from koala_tpu_torch.constants import FRAME_LENGTH
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models import demucs, params_io
from koala_tpu_torch.models.base import Placeholder
from koala_tpu_torch.ops.kernels import overlap, rowmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "benchmark", "configs", "demucs-dns64.json")) as _f:
    DNS64 = json.load(_f)["model"]


def _randn(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32))


def _rnd(t):
    return t.bfloat16().float()


# (form, K, C) of a product: C outputs, or C GLU pairs (a multiple of 32,
# paired by blocks; the other forms take any C)
CASES = [(form, k, c) for form in ("bias", "bias_relu_round") for k, c in
         ((8, 64), (64, 32), (24, 12))] + \
        [(form, k, c) for form in ("glu", "glu_round") for k, c in ((8, 64), (64, 32), (24, 96))]


@pytest.mark.parametrize("form,k,c", CASES)
def test_fused_plain_version_equals_the_separate_ops(form, k, c):
    """Each form of the fused entry's plain version against rowmm's plain
    version and the PyTorch ops in the plain path's order, with A a
    row-strided window rounded on load where the form rounds, and the GLU's
    output written into a slice of a larger buffer."""
    glu = form.startswith("glu")
    n = 2 * c if glu else c
    rows, steps = 3, 37
    base = _randn(1, (rows, 4 * steps + 4 + k))
    a = base.as_strided((rows, steps, k), (base.stride(0), 4, 1))      # frames of a window
    w, bias = _rnd(_randn(2, (k, n), 0.3)), _randn(3, (n,), 0.5)
    round_a = form == "bias_relu_round"
    z = rowmm.rowmm_ref(_rnd(a) if round_a else a.contiguous(), w) + bias
    if form == "bias_relu_round":
        want = _rnd(z.relu())
    elif glu:
        want = z[..., :c] * z[..., c:].sigmoid()
        want = _rnd(want) if form == "glu_round" else want
    else:
        want = z
    if glu:
        buf = torch.full((rows, steps + 5, c), 7.0)
        got = rowmm.fused(a, rowmm.pair_glu(w).contiguous(), rowmm.pair_glu(bias).contiguous(),
                          glu=True, round_out=form == "glu_round", out=buf[:, 5:])
        assert torch.equal(buf[:, :5], torch.full((rows, 5, c), 7.0))
    else:
        got = rowmm.fused(a, w, bias, relu=round_a, round_a=round_a, round_out=round_a)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("c", [4, 12, 32, 64, 96])
def test_pair_glu_reads_back(c):
    """pair_glu then unpair_glu is the identity; in blocks of 32 a value
    column and its gate sit 32 apart in one block of 64. A C that is no
    multiple of 32 is refused, by both and by the plain version's GLU."""
    w = _randn(4, (5, 2 * c))
    if c % 32:
        for fn in (rowmm.pair_glu, rowmm.unpair_glu):
            with pytest.raises(ValueError, match="blocks of 32"):
                fn(w)
        with pytest.raises(ValueError, match="blocks of 32"):
            rowmm.fused(w, torch.eye(2 * c), torch.zeros(2 * c), glu=True)
        return
    paired = rowmm.pair_glu(w)
    assert torch.equal(rowmm.unpair_glu(paired), w)
    for ch in (0, 31, c - 1):
        blk, lane = divmod(ch, 32)
        assert torch.equal(paired[:, 64 * blk + lane], w[:, ch])
        assert torch.equal(paired[:, 64 * blk + 32 + lane], w[:, c + ch])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_operands_read_back_to_the_state_dict(dtype):
    """``enc{k}.glu`` and ``dec{k}.glu`` (weights and biases) unpair to the
    1x1 convolutions of denoiser's state_dict, at channels 32 .. 512."""
    cfg = dict(DNS64, hidden=32, init_seed=3, compute_dtype=dtype)
    params = demucs.params_from_tree(params_io.params_to_numpy(Placeholder()), cfg)
    sd = params.state_dict()
    for k in range(1, 6):
        for level, key in (("enc%d" % k, "encoder.%d.2" % (k - 1)),
                           ("dec%d" % k, "decoder.%d.0" % (5 - k))):
            w = sd[key + ".weight"][:, :, 0].t()
            want = _rnd(w) if dtype == "bfloat16" else w
            assert torch.equal(rowmm.unpair_glu(params.operand(level + ".glu", dtype)), want)
            assert torch.equal(params.operand(level + ".1x1", dtype), want)
            assert torch.equal(rowmm.unpair_glu(params.bias(level + ".glu")), sd[key + ".bias"])


def _fused_products(streams, hops, cfg):
    """(m, n, k, glu) of a block's products that go through ``rowmm.fused``."""
    lay, ch = demucs.layout(cfg["depth"], cfg["delay_hops"]), demucs.channels(cfg)
    out = []
    for lvl in range(1, cfg["depth"] + 1):
        m = streams * lay.per_hop[lvl] * hops
        out += [(m, ch[lvl], 8 * ch[lvl - 1], False), (m, 2 * ch[lvl], ch[lvl], True),
                (m, 2 * ch[lvl], ch[lvl], True)]
    return out


def test_the_cells_products_take_the_fused_kernel():
    """Each of dns64's 15 fused products a block launches a fused kernel on
    a card at any row count, the variant ``fused_plan`` picks: at the
    cell's 2048 streams, blocks of 8 hops and the last of 7, the tile (705
    launches over 375 hops, 47 blocks); one stream's hop the narrow kernels
    (16 rows a block at levels 1-3, 4 at levels 4-5); two streams' block of
    24 hops the tile at levels 1-2. Every GLU pairs (C a multiple of 32)."""
    assert demucs.block_hops(2048, DNS64) == 8
    tile = len(rowmm.FUSED_VARIANTS) - 1
    for hops in (8, 7):
        assert all(rowmm.fused_plan(m) == tile for m, *_ in _fused_products(2048, hops, DNS64))
    assert 47 * len(_fused_products(2048, 8, DNS64)) == 705
    one = [rowmm.fused_plan(m) for m, *_ in _fused_products(1, 1, DNS64)]
    assert one == [1] * 9 + [0] * 6
    two = [rowmm.fused_plan(m) for m, *_ in _fused_products(2, 24, DNS64)]
    assert two == [tile] * 6 + [1] * 9
    assert all(n % (2 * rowmm.GLU_BLOCK) == 0 for _, n, _, glu in _fused_products(1, 1, DNS64)
               if glu)
    assert rowmm.FUSED_VARIANTS == (
        "fused narrow<4,128,4>", "fused narrow<16,64,5>", "fused tile<128,64>")


@pytest.mark.parametrize("relu,skip,round_out", [(True, True, True), (False, False, False),
                                                 (True, False, False)])
@pytest.mark.parametrize("c", [1, 8])
def test_overlap_plain_version_is_the_formula(relu, skip, round_out, c):
    """overlap_add's plain version against the formula, element by element
    in float32: out[4 i + q] = round(relu((p[i, 0, q] + prev) + bias) + skip),
    prev the last position's second half or the carry, carry' the last
    second half."""
    rows, n = 2, 5
    p = _randn(5, (rows, n, 2, 4, c))
    carry, bias = _randn(6, (rows, 4, c)), _randn(7, (c,))
    buf = _randn(8, (rows, 4 * n + 3, c))
    sk = buf[:, :4 * n] if skip else None
    out, new = overlap.overlap_add(p, carry, bias, relu, sk, round_out)
    pn, cn, bn = p.numpy(), carry.numpy(), bias.numpy()
    want = np.empty((rows, 4 * n, c), np.float32)
    for i in range(n):
        prev = pn[:, i - 1, 1] if i > 0 else cn
        y = (pn[:, i, 0] + prev) + bn
        if relu:
            y = np.maximum(y, np.float32(0))
        if skip:
            y = y + buf[:, 4 * i:4 * i + 4].numpy()
        want[:, 4 * i:4 * i + 4] = y
    want_t = torch.as_tensor(want)
    assert torch.equal(out, _rnd(want_t) if round_out else want_t)
    assert torch.equal(new, p[:, -1, 1])


def _hops(b, t, seed=5):
    bank = audio.Bank(REPO, "cpu")
    plan = audio.Plan(np.random.default_rng(seed), b, bank.length)
    return audio.mix_blocks(bank, plan, t * FRAME_LENGTH).reshape(b, t, FRAME_LENGTH)


def _run(cfg, params, hops, cut):
    eng = make_engine("demucs", cfg)
    st, outs = eng.init_state(hops.shape[:1], "cpu"), []
    with torch.inference_mode():
        for lo in range(0, hops.shape[1], cut):
            st, o = eng.sequence(params, st, hops[:, lo:lo + cut])
            outs.append(o)
    return st, torch.cat(outs, dim=1)


@pytest.mark.parametrize("hidden", [4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_path_gives_the_plain_paths_bits(monkeypatch, hidden, dtype):
    """The fused encoder and decoder against their plain versions: the
    outputs and every state leaf, in calls of 7 hops over 16 (the head's
    masks and the carries included), at channels 4 .. 64 and 16 .. 256."""
    cfg = dict(DNS64, hidden=hidden, init_seed=9, compute_dtype=dtype)
    params = demucs.params_from_tree(params_io.params_to_numpy(Placeholder()), cfg)
    hops = _hops(2, 16)
    st, out = _run(cfg, params, hops, 7)
    monkeypatch.setattr(demucs, "_encoder", demucs._encoder_plain)
    monkeypatch.setattr(demucs, "_decoder", demucs._decoder_plain)
    st_plain, out_plain = _run(cfg, params, hops, 7)
    assert torch.equal(out, out_plain) and float(out[:, 3:].abs().max()) > 0
    for key in st_plain["model"]:
        assert torch.equal(st["model"][key], st_plain["model"][key]), key


def test_the_encoder_and_decoder_spans_count_fused_launches():
    """Under a profiler each block's demucs.encoder and demucs.decoder spans
    carry ``fused`` (none on the CPU) beside ``launches``; the other spans
    do not."""
    cfg = dict(DNS64, hidden=4, init_seed=9)
    params = demucs.params_from_tree(params_io.params_to_numpy(Placeholder()), cfg)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(cfg, params, _hops(1, 3), 3)
    found = [s for s in profiling.spans(t0) if s.name.startswith("demucs.")]
    assert {s.name for s in found} == {"demucs.resample", "demucs.encoder", "demucs.lstm",
                                       "demucs.decoder"}
    for s in found:
        fused = s.name in ("demucs.encoder", "demucs.decoder")
        assert ("fused" in s.counts) == fused and s.counts["launches"] == 0, s
        assert s.counts.get("fused", 0) == 0
