"""The port's FullSubNet (models/fullsubnet.py) on the CPU at small widths
(full band 32, sub band 16, all 257 bins) with seeded weights: against the
benchmark's plain reference (benchmark/reference/fullsubnet.py, which shares
nothing with the port), step against sequence, the engine's complex mask,
the model file, every public entry point, and the LSTM kernel's plain
version against the cell's equations."""

import os
import time

import numpy as np
import pytest
import torch

import koala_tpu_torch
from benchmark import audio
from benchmark.reference import fullsubnet as ref
from benchmark.reference.pv import read_pv
from koala_tpu_torch.constants import FRAME_LENGTH
from koala_tpu_torch.engine.core import apply_mask, make_engine
from koala_tpu_torch.models import fullsubnet, mask_gru, mmse, params_io
from koala_tpu_torch.models.base import constant_on
from koala_tpu_torch.ops.kernels import lstm
from koala_tpu_torch.parallel.mesh import make_mesh
from koala_tpu_torch.parallel.runner import CorpusRunner
from koala_tpu_torch.serve import StreamingServer

from torch_ref import ACCESS_KEY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 3, 20
SMALL = dict(fullsubnet.DEFAULT_CONFIG, fb_hidden=32, sb_hidden=16)
# bf16 products against the reference's: both round the same operands to
# bf16, but the port's fixed-order sums and the library's differ in their
# last f32 bit, and now and then that flips the bf16 rounding of an LSTM
# input, which the recurrence carries (1.7e-5 of a stream seen); 50 times that
F32_TOL, BF16_TOL = 1e-5, 1e-3


def _hops(b=B, t=T, seed=5):
    bank = audio.Bank(REPO, "cpu")
    plan = audio.Plan(np.random.default_rng(seed), b, bank.length)
    return audio.mix_blocks(bank, plan, t * FRAME_LENGTH).reshape(b, t, FRAME_LENGTH)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request, tmp_path_factory):
    """(config, params, model file) at a compute dtype, seeded weights
    through a .pv round trip (the reference reads the same file)."""
    cfg = dict(SMALL, compute_dtype=request.param)
    path = str(tmp_path_factory.mktemp("fsn") / ("fsn_%s.pv" % request.param))
    params_io.save_params(path, fullsubnet.init_params(torch.Generator().manual_seed(3), cfg),
                          cfg)
    tree, file_cfg = params_io.load_params(path)
    return file_cfg, params_io.params_from_numpy(tree, "cpu", "fullsubnet"), path


@pytest.fixture(scope="module")
def bf16_file(tmp_path_factory):
    cfg = dict(SMALL)
    path = str(tmp_path_factory.mktemp("fsn") / "fsn.pv")
    params_io.save_params(path, fullsubnet.init_params(torch.Generator().manual_seed(4), cfg),
                          cfg)
    return path


def _rel(out, want):
    """Each stream's ||out - want|| / ||want||."""
    d = (out.double() - want.double()).flatten(1).norm(dim=1)
    return (d / want.double().flatten(1).norm(dim=1)).tolist()


def test_matches_the_plain_reference(model):
    cfg, params, path = model
    hops = _hops()
    eng = make_engine("fullsubnet", cfg)
    with torch.inference_mode():
        _, out = eng.sequence(params, eng.init_state((B,), "cpu"), hops)
    flat, file_cfg = read_pv(path)
    want = ref.enhance(ref.Weights(flat, file_cfg, "cpu"), hops, cfg["compute_dtype"], "float32")
    tol = F32_TOL if cfg["compute_dtype"] == "float32" else BF16_TOL
    assert max(_rel(out, want)) < tol, _rel(out, want)
    assert float(want.abs().max()) > 0.05     # not silence


def test_step_frame_by_frame_equals_apply_sequence(model):
    """The step's arithmetic is the sequence's: masks and every state leaf
    bit for bit."""
    cfg, params, _ = model
    hops = _hops()
    frames = torch.cat([torch.cat([torch.zeros_like(hops[:, :1]), hops[:, :-1]], 1), hops], -1)
    from koala_tpu_torch.ops.stft import stft_frame
    re, im = stft_frame(frames)
    with torch.inference_mode():
        st_seq, (mr, mi) = fullsubnet.apply_sequence(
            params, fullsubnet.init_state((B,), cfg, "cpu"), re, im, cfg)
        st = fullsubnet.init_state((B,), cfg, "cpu")
        for t in range(T):
            st, (sr, si) = fullsubnet.step(params, st, re[:, t], im[:, t], cfg)
            assert torch.equal(sr, mr[:, t]) and torch.equal(si, mi[:, t]), t
    for k in st:
        assert torch.equal(st[k], st_seq[k]), k
    assert set(st) == {"fb_h", "fb_c", "sb_h", "sb_c", "fb_sum", "sb_sum", "count"}
    assert st["sb_h"].shape == (B, 257, 2, 16) and st["fb_c"].shape == (B, 2, 32)
    assert torch.equal(st["count"], torch.full((B,), float(T)))


def test_engine_step_and_sequence_agree_on_one_stream(model):
    """An unbatched stream: Engine.step hop by hop against one sequence call."""
    cfg, params, _ = model
    hops = _hops(1)[0]
    eng = make_engine("fullsubnet", cfg)
    with torch.inference_mode():
        _, seq = eng.sequence(params, eng.init_state((), "cpu"), hops)
        st, outs = eng.init_state((), "cpu"), []
        for t in range(T):
            st, o = eng.step(params, st, hops[t])
            outs.append(o)
    assert torch.equal(torch.stack(outs), seq)


@pytest.mark.parametrize("kind", ["mask_gru", "mmse"])
def test_a_complex_mask_with_a_zero_imaginary_half_changes_no_bit(kind, monkeypatch):
    """mask_gru and mmse through the engine as they are, then with their
    masks handed over as (mask, 0): the same output, bit for bit, on the
    step and on the sequence."""
    if kind == "mmse":
        tree, cfg = {"empty": np.zeros((1,), np.float32)}, dict(mmse.DEFAULT_CONFIG)
        module = mmse
    else:
        tree, cfg = params_io.load_params(params_io.default_model_path())
        module = mask_gru
    params = params_io.params_from_numpy(tree, "cpu", kind)
    eng = make_engine(kind, cfg)
    hops = _hops()

    def run():
        with torch.inference_mode():
            _, seq = eng.sequence(params, eng.init_state((B,), "cpu"), hops)
            st, outs = eng.init_state((B,), "cpu"), []
            for t in range(4):
                st, o = eng.step(params, st, hops[:, t])
                outs.append(o)
        return seq, torch.stack(outs, 1)

    real = run()

    def as_complex(fn):
        def wrapped(*a, **k):
            st, m = fn(*a, **k)
            return st, (m, torch.zeros_like(m))
        return wrapped

    class Complex:
        init_state = module.init_state
        step = as_complex(module.step)
        apply_sequence = as_complex(module.apply_sequence)
    monkeypatch.setattr(eng, "model", Complex)
    cplx = run()
    assert torch.equal(real[0], cplx[0]) and torch.equal(real[1], cplx[1])


def test_apply_mask_is_the_complex_product():
    g = torch.Generator().manual_seed(0)
    re, im, mr, mi = (torch.randn(4, 257, generator=g) for _ in range(4))
    yr, yi = apply_mask(re, im, (mr, mi))
    want = torch.complex(mr, mi) * torch.complex(re, im)
    assert torch.allclose(yr, want.real, atol=1e-6) and torch.allclose(yi, want.imag, atol=1e-6)
    r2, i2 = apply_mask(re, im, mr)
    assert torch.equal(r2, re * mr) and torch.equal(i2, im * mr)


def test_model_file_round_trip(bf16_file):
    tree, cfg = params_io.load_params(bf16_file)
    assert cfg["kind"] == "fullsubnet" and cfg["sb_hidden"] == 16
    params = params_io.params_from_numpy(tree, "cpu", "fullsubnet")
    again = params_io.params_to_numpy(params)
    flat = params_io._flatten(again)
    assert flat.keys() == params_io._flatten(tree).keys()
    assert {"fb/lstm/0/w_ih", "fb/fc/w", "sb/lstm/1/b_hh", "sb/fc/b"} <= set(flat)
    for k, v in params_io._flatten(tree).items():
        assert np.array_equal(flat[k], v), k
    assert flat["sb/lstm/0/w_ih"].shape == (64, 32)
    assert flat["fb/lstm/0/w_ih"].shape == (128, 257)


def test_committed_model_file_is_the_scripts():
    """models/fullsubnet/fullsubnet_random.pv holds the recipe's widths and is
    what scripts/make_fullsubnet_pv_torch.py writes from its seed (in a folder
    of its own: every models/*.pv is a mask_gru file that the JAX package's
    tests load)."""
    tree, cfg = params_io.load_params(os.path.join(REPO, "models", "fullsubnet",
                                                   "fullsubnet_random.pv"))
    assert cfg == dict(fullsubnet.DEFAULT_CONFIG)
    params = params_io.params_from_numpy(tree, "cpu", "fullsubnet")
    assert fullsubnet.num_params(params) == 5637635
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_fsn", os.path.join(REPO, "scripts", "make_fullsubnet_pv_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fresh = fullsubnet.init_params(torch.Generator().manual_seed(script.SEED), cfg)
    for (k, a), (_, b) in zip(sorted(params.state_dict().items()),
                              sorted(fresh.state_dict().items())):
        assert torch.equal(a, b.half().float()), k


def _process(path, pcm):
    """Koala.process frame by frame on each stream: the yardstick."""
    outs = []
    for row in pcm:
        k = koala_tpu_torch.create(ACCESS_KEY, model_path=path, device="cpu")
        try:
            outs.append(np.concatenate([k.process(row[s:s + FRAME_LENGTH])
                                        for s in range(0, len(row), FRAME_LENGTH)]))
        finally:
            k.delete()
    return np.stack(outs)


def _lsb(a, b):
    return int(np.max(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))))


@pytest.fixture(scope="module")
def surface(bf16_file):
    pcm = np.round(_hops().reshape(B, -1).numpy() * 32768.0).clip(-32768, 32767).astype(np.int16)
    return bf16_file, pcm, _process(bf16_file, pcm)


# a stream's frames through another entry point than Koala.process: the same
# products and sums, row for row; only PyTorch's vectorised transcendental
# functions on the CPU round a tensor's last elements through their scalar
# forms, so the int16 output may move by a rounding
SURFACE_LSB = 1


def test_koala_enhance_agrees_with_process(surface):
    path, pcm, want = surface
    k = koala_tpu_torch.create(ACCESS_KEY, model_path=path, device="cpu")
    try:
        got = []
        for row in pcm:
            got.append(k.enhance(row))
            k.reset()
        got = np.stack(got)
        delay = k.delay_sample
    finally:
        k.delete()
    assert got.shape == pcm.shape
    assert _lsb(got[:, :-delay], want[:, delay:]) <= SURFACE_LSB
    assert np.abs(want).max() > 1000


def test_koala_batch_agrees_with_process(surface):
    path, pcm, want = surface
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, B, model_path=path, device="cpu")
    try:
        frames = [kb.process(pcm[:, s:s + FRAME_LENGTH]) for s in range(0, pcm.shape[1],
                                                                         FRAME_LENGTH)]
        kb.reset()
        chunk = kb.process_chunk(pcm)
    finally:
        kb.delete()
    assert _lsb(np.concatenate(frames, axis=1), want) <= SURFACE_LSB
    assert _lsb(np.asarray(chunk).reshape(B, -1), want) <= SURFACE_LSB


def test_corpus_runner_agrees_with_process(surface):
    path, pcm, want = surface
    runner = CorpusRunner(path, B, pcm.shape[1], mesh=make_mesh(["cpu"]))
    out = runner.enhance_batch(pcm.astype(np.float32) / 32768.0)
    got = np.clip(np.round(out.reshape(B, -1).numpy().astype(np.float64) * 32768.0),
                  -32768, 32767)
    assert _lsb(got, want) <= SURFACE_LSB


@pytest.mark.parametrize("chunk_frames", [8, 1])
def test_streaming_server_agrees_with_process(surface, chunk_frames):
    """Backlog rounds (the sequence over full chunks, the masked step for
    the rest) and frame-by-frame rounds."""
    path, pcm, want = surface
    server = StreamingServer(ACCESS_KEY, model_path=path, device="cpu", num_streams=B,
                             chunk_frames=chunk_frames)
    try:
        for s in range(B):
            server.push(s, pcm[s])
        outs = []
        for s in range(B):
            got, deadline = [], time.time() + 60
            while sum(len(g) for g in got) < pcm.shape[1] and time.time() < deadline:
                chunk = server.pull(s)
                if len(chunk):
                    got.append(chunk)
                else:
                    time.sleep(0.005)
            outs.append(np.concatenate(got))
    finally:
        server.close()
    assert _lsb(np.stack(outs), want) <= SURFACE_LSB


@pytest.mark.parametrize("kx,h", [(257, 32), (32, 16)])
def test_lstm_plain_version_is_the_cell(kx, h):
    """The kernel's plain version against torch.nn.LSTMCell on the same
    bf16-rounded weights and inputs, in float64: the rounding of f32 sums."""
    g = torch.Generator().manual_seed(kx)
    cell = torch.nn.LSTMCell(kx, h)
    with torch.no_grad():
        for p in cell.parameters():
            p.copy_(p.bfloat16().float())
    x = torch.randn(70, kx, generator=g)
    h0 = torch.randn(70, h, generator=g) * 0.5
    c0 = torch.randn(70, h, generator=g)
    w, b = lstm.stack_weights(cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)
    assert w.shape == (4 * h, lstm.padded(kx) + h) and w.dtype == torch.bfloat16
    with torch.no_grad():
        want_h, want_c = cell.double()(x.bfloat16().double(),
                                       (h0.bfloat16().double(), c0.double()))
    got_h, got_c = lstm.lstm_cell(x, h0, c0, w, b)
    assert torch.allclose(got_h.double(), want_h, atol=2e-6)
    assert torch.allclose(got_c.double(), want_c, atol=4e-6)


def test_lstm_plain_version_row_by_row():
    """A row's h' and c' do not depend on how many rows share the call, and
    strided views of a [rows, L, H] state go in and come out as they lie."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(100, 32, generator=g)
    state = torch.randn(100, 2, 16, generator=g)
    w, b = lstm.stack_weights(*(torch.randn(s, generator=g) * 0.2
                                for s in ((64, 32), (64, 16), (64,), (64,))))
    h_out, c_out = torch.empty(100, 2, 16), torch.empty(100, 2, 16)
    lstm.lstm_cell(x, state[:, 0], state[:, 1], w, b, h_out[:, 1], c_out[:, 1])
    one_h, one_c = lstm.lstm_cell(x[37:38], state[37:38, 0], state[37:38, 1], w, b)
    assert torch.equal(one_h[0], h_out[37, 1]) and torch.equal(one_c[0], c_out[37, 1])


@pytest.mark.parametrize("rows,kx,h,want", [
    (526336, 32, 384, (128, 12, 1)),      # the sub-band at B = 2048: 2056 pairs of tiles
    (526336, 384, 384, (128, 12, 1)),
    (2048, 257, 512, (64, 4, 4)),         # the full band: 16 pairs x 4 groups of passes
    (2048, 512, 512, (64, 4, 4)),
    (257, 32, 384, (128, 1, 12)),         # one stream's sub-band: 2 pairs x 12 passes
    (1, 32, 384, (128, 1, 12)),
    (100, 32, 16, (128, 1, 1)),
])
def test_lstm_plan(rows, kx, h, want):
    """The kernel's launch plan: (tile rows, passes a block, pass groups); a
    work item is a pair of row tiles (a cluster of two blocks) and a group."""
    assert lstm.plan(rows, kx, h) == want
    tile, per_block, groups = want
    passes = -(-h // lstm.UNITS)
    assert per_block * groups >= passes > per_block * (groups - 1)
    # K's A tile (bf16, 64-deep panels) and the ring fit in a block
    k = lstm.padded(kx) + h
    ring = lstm.RING_128 if tile == 128 else lstm.RING_64
    assert lstm.SMEM_SLACK + tile * -(-k // 64) * 128 + ring * lstm.STAGE_BYTES <= lstm.SMEM_BYTES


@pytest.mark.parametrize("kx,h,tile", [(32, 384, 128), (384, 384, 128), (257, 512, 64),
                                       (512, 512, 64)])
def test_lstm_tile_height_follows_the_width_alone(kx, h, tile):
    """A row's sum order is the tile's: the same tile height at every row
    count of a width, so a stream's bits do not depend on its batch."""
    assert lstm.tile_rows(kx, h) == tile
    for rows in (1, 63, 64, 127, 128, 129, 257, 2048, 4112, 526336, 526336 - 29):
        assert lstm.plan(rows, kx, h)[0] == tile, rows


def test_lstm_weights_in_pass_order():
    """stack_weights lays W^T out in pass order (row 32 g + 8 q + t: gate q
    of unit 8 g + t), x padded with zero columns to 16; unstack gives
    PyTorch's [K, 4H] back."""
    g = torch.Generator().manual_seed(2)
    kx, h = 20, 48
    w_ih, w_hh = torch.randn(4 * h, kx, generator=g), torch.randn(4 * h, h, generator=g)
    w, b = lstm.stack_weights(w_ih, w_hh, torch.zeros(4 * h), torch.ones(4 * h))
    assert w.shape == (4 * h, 32 + h) and torch.equal(b, torch.ones(4 * h))
    for q in range(4):
        for unit in (0, 7, 8, 33, 47):
            row = 32 * (unit // 8) + 8 * q + unit % 8
            assert torch.equal(w[row, :kx], w_ih[q * h + unit].bfloat16())
            assert not w[row, kx:32].any()
            assert torch.equal(w[row, 32:], w_hh[q * h + unit].bfloat16())
    want = torch.cat([w_ih.bfloat16(), torch.zeros(4 * h, 32 - kx, dtype=torch.bfloat16),
                      w_hh.bfloat16()], dim=1).t()
    assert torch.equal(lstm.unstack(w), want)


def test_lstm_bound_counts():
    ms = lstm.bound(526336, 32, 384)
    assert ms["operations"] == pytest.approx(2 * 526336 * 416 * 1536 / 989e12 * 1e3)
    assert ms["bytes"] > ms["operations"] > 0.5


@pytest.mark.parametrize("key,value", [("fb_num_neighbors", 1), ("look_ahead", 2),
                                       ("norm", "offline_laplace"), ("compute_dtype", "float16")])
def test_unsupported_settings_raise(key, value):
    with pytest.raises(ValueError):
        fullsubnet.init_state((1,), dict(SMALL, **{key: value}), "cpu")


def test_neighbours_are_reflect_padding():
    idx = constant_on(fullsubnet._neighbours, torch.device("cpu"), 257, 15)
    mag = torch.arange(257.0)
    padded = torch.nn.functional.pad(mag[None, None], (15, 15), mode="reflect")[0, 0]
    want = padded.unfold(0, 31, 1)
    assert torch.equal(mag[idx], want)
    assert np.array_equal(idx.numpy(), ref.neighbours(257, 15))
