"""The port's Demucs (models/demucs.py) on the CPU at a small width (hidden
4: channels 4 .. 64, the LSTM 64 wide; depth, kernel, stride and resampling
as published, since they make the 256-sample hop), its weights drawn from a
seed: against the benchmark's plain reference (benchmark/reference/demucs.py,
which shares nothing with the port), every cut of a stream into calls, the
model's lookahead against its declared delay, every public entry point, and
the LSTM kernel's plain version and tile plan at Demucs's depth 2048."""

import json
import os
import time

import numpy as np
import pytest
import torch

import koala_tpu_torch
from benchmark import audio
from benchmark.reference import demucs as ref
from koala_tpu_torch.constants import FRAME_LENGTH
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models import demucs, params_io
from koala_tpu_torch.models.base import Placeholder
from koala_tpu_torch.ops.kernels import lstm
from koala_tpu_torch.parallel.mesh import make_mesh
from koala_tpu_torch.parallel.runner import CorpusRunner
from koala_tpu_torch.serve import StreamingServer

from torch_ref import ACCESS_KEY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "benchmark", "configs", "demucs-dns64.json")) as _f:
    DNS64 = json.load(_f)["model"]
SMALL = dict(DNS64, hidden=4, init_seed=11)
B, T = 3, 20
# The reference test's width: at hidden 4 the random model's output is nearly
# its last bias times the scale, so it runs at hidden 16 (channels 16 .. 256),
# where the products' precision shows.
WIDE = dict(DNS64, hidden=16, init_seed=11)
# Against the reference, whose products are the library's (another order of
# f32 sums) and whose layout is channels first, as the largest stream's
# ||out - ref|| / ||ref||. At f32 products it reads 2.3e-7; the bf16 program
# reads 2.3e-3 against the f32 reference. At bf16 products both round the same
# operands, and an f32 sum's last bit now and then flips a bf16 rounding,
# which the layers carry on: 4.0e-4; the f32 program reads 2.3e-3 against the
# bf16 reference. Each tolerance lies between its two readings.
TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _hops(b=B, t=T, seed=5):
    bank = audio.Bank(REPO, "cpu")
    plan = audio.Plan(np.random.default_rng(seed), b, bank.length)
    return audio.mix_blocks(bank, plan, t * FRAME_LENGTH).reshape(b, t, FRAME_LENGTH)


def _placeholder_file(path, cfg):
    params_io.save_params(path, Placeholder(), cfg)
    return path


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    cfg = dict(SMALL, compute_dtype=request.param)
    return cfg, demucs.params_from_tree(params_io.params_to_numpy(Placeholder()), cfg)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return _placeholder_file(str(tmp_path_factory.mktemp("demucs") / "demucs_small.pv"), SMALL)


def _rel(out, want):
    d = (out.double() - want.double()).flatten(1).norm(dim=1)
    return (d / want.double().flatten(1).norm(dim=1)).tolist()


def _sequence(cfg, params, hops, cut=None):
    eng = make_engine("demucs", cfg)
    st, outs = eng.init_state(hops.shape[:1], "cpu"), []
    cut = cut or hops.shape[1]
    with torch.inference_mode():
        for lo in range(0, hops.shape[1], cut):
            st, o = eng.sequence(params, st, hops[:, lo:lo + cut])
            outs.append(o)
    return st, torch.cat(outs, dim=1)


@pytest.fixture(scope="module")
def wide():
    """Both precisions at hidden 16: {dtype: (config, params)}."""
    out = {}
    for dtype in TOL:
        cfg = dict(WIDE, compute_dtype=dtype)
        out[dtype] = cfg, demucs.params_from_tree(params_io.params_to_numpy(Placeholder()), cfg)
    return out


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_matches_the_plain_reference(wide, dtype):
    """The program against the reference at its own precision, within that
    precision's tolerance; against the other precision's reference, past it."""
    cfg, params = wide[dtype]
    hops = _hops()
    _, out = _sequence(cfg, params, hops)
    weights = ref.Weights({"empty": np.zeros(1)}, cfg, "cpu")
    want = {p: ref.enhance(weights, hops, p, "float32") for p in TOL}
    other = "float32" if dtype == "bfloat16" else "bfloat16"
    assert max(_rel(out, want[dtype])) < TOL[dtype]
    assert max(_rel(out, want[other])) > TOL[dtype]
    assert float(out[:, :3].abs().max()) == 0.0 and float(want[dtype][:, 3:].abs().max()) > 1e-3


@pytest.mark.parametrize("cut", [1, 2, 3, 7])
def test_every_cut_gives_the_same_bits(model, cut):
    """Calls of 1, 2, 3 and 7 hops and one call: the outputs and every state
    leaf bit for bit."""
    cfg, params = model
    hops = _hops()
    st_whole, whole = _sequence(cfg, params, hops)
    st_cut, parts = _sequence(cfg, params, hops, cut)
    assert torch.equal(parts, whole)
    for k in st_whole["model"]:
        assert torch.equal(st_cut["model"][k], st_whole["model"][k]), k


def test_step_equals_sequence_on_one_stream(model):
    """An unbatched stream: Engine.step hop by hop against one sequence call."""
    cfg, params = model
    hops = _hops(1)[0]
    eng = make_engine("demucs", cfg)
    with torch.inference_mode():
        _, seq = eng.sequence(params, eng.init_state((), "cpu"), hops)
        st, outs = eng.init_state((), "cpu"), []
        for t in range(T):
            st, o = eng.step(params, st, hops[t])
            outs.append(o)
    assert torch.equal(torch.stack(outs), seq)
    assert st["model"]["count"].shape == () and st["model"]["lstm_h"].shape == (2, 64)


def test_state_layout_and_lags():
    """The fixed pipeline's carries and lags at the published layout, and the
    state a stream holds (batch axes leading)."""
    lay = demucs.layout(5, 3)
    assert lay.enc_lag == (336, 85, 23, 7, 3, 2) and lay.enc_carry == (0, 4, 7, 5, 5, 5)
    assert lay.dec_lag == (2048, 512, 128, 32, 8, 2) and lay.skip[1:5] == (427, 105, 25, 5)
    assert lay.z1_lag == 1080 and lay.out_pairs == 284
    st = demucs.init_state((2, 3), DNS64, "cpu")
    assert st["skip1"].shape == (2, 3, 427, 64) and st["overlap5"].shape == (2, 3, 4, 512)
    assert st["lstm_c"].shape == (2, 3, 2, 1024) and st["resample_out"].shape == (2, 3, 568)
    assert st["scales"].shape == (2, 3, 3)
    with pytest.raises(ValueError):
        demucs.resolve(dict(DNS64, delay_hops=2))


def test_lookahead_fits_the_delay():
    """In the reference: input changed after hop t changes no output hop up
    to t (output hop t is the offline hop t - 3)."""
    cfg = dict(SMALL, compute_dtype="float32")
    w = ref.Weights({"empty": np.zeros(1)}, cfg, "cpu")
    hops = _hops(2, 16)
    base = ref.enhance(w, hops, "float32", "float32")
    for t in (3, 8, 12):
        changed = hops.clone()
        changed[:, t + 1:] = torch.randn_like(changed[:, t + 1:]) * 0.3
        out = ref.enhance(w, changed, "float32", "float32")
        assert torch.equal(out[:, :t + 1], base[:, :t + 1]), t
        assert not torch.equal(out[:, t + 1:], base[:, t + 1:])


@pytest.mark.parametrize("n", [1000, 1023, 2049, 2303])
def test_an_input_sample_reaches_no_output_before_it_plus_4(n):
    """The sign of input sample n flipped (so that no hop's mean square, and
    no scale, moves) changes no sample of the delayed output before n + 4:
    the 768-sample delay less the model's 764-sample lookahead. In the
    program, which streams it."""
    cfg = dict(SMALL, compute_dtype="float32")
    params = demucs.params_from_tree(params_io.params_to_numpy(Placeholder()), cfg)
    hops = _hops(1, 16)
    flipped = hops.clone().reshape(1, -1)
    flipped[0, n] = -flipped[0, n]
    _, base = _sequence(cfg, params, hops)
    _, out = _sequence(cfg, params, flipped.reshape(1, 16, FRAME_LENGTH))
    diff = (out - base).reshape(-1).abs()
    assert float(diff[:n + 4].max()) == 0.0 and float(diff[n + 4:].max()) > 0.0


def test_delay_sample_is_the_models():
    assert make_engine("demucs", DNS64).delay_sample == 768
    assert make_engine("demucs", dict(DNS64, delay_hops=4)).delay_sample == 1024
    for kind in ("mask_gru", "mmse", "fullsubnet", "identity"):
        assert make_engine(kind, {"kind": kind}).delay_sample == 256, kind


def test_num_params_at_the_published_widths():
    """dns64: 33,533,569 (the encoder's 8,370,496, the LSTM's 16,793,600, the
    decoder's 8,369,473)."""
    params = demucs.init_params(torch.Generator().manual_seed(0), DNS64)
    assert params.num_params() == 33533569
    sd = params.state_dict()
    part = {p: sum(v.numel() for k, v in sd.items() if k.startswith(p))
            for p in ("encoder.", "lstm.", "decoder.")}
    assert part == {"encoder.": 8370496, "lstm.": 16793600, "decoder.": 8369473}
    assert tuple(sd["decoder.0.2.weight"].shape) == (1024, 512, 8)
    assert tuple(sd["encoder.0.0.weight"].shape) == (64, 1, 8)
    assert tuple(sd["lstm.lstm.weight_ih_l1"].shape) == (4096, 1024)


def test_the_seeded_draw_is_the_references():
    """The program's draw from init_seed and the reference's own code give the
    same tensors, bit for bit, under denoiser's state_dict names."""
    cfg = dict(DNS64, hidden=8, init_seed=2 ** 31 + 5)
    params = demucs.params_from_tree(params_io.params_to_numpy(Placeholder()), cfg)
    mine, theirs = params.state_dict(), ref.draw(cfg)
    assert set(mine) == set(theirs)
    for k in theirs:
        assert torch.equal(mine[k], theirs[k]), k
    # rescaled: each convolution's weight std sqrt(0.1 x its drawn std)
    assert 0.05 < float(mine["encoder.0.0.weight"].std()) < 0.3


def test_a_file_with_weights_loads_as_it_is(tmp_path):
    """A model file that holds the weights (denoiser's names through the
    .pv's flat paths) loads as they are, not drawn."""
    cfg = dict(SMALL, init_seed=0)
    params = demucs.init_params(torch.Generator().manual_seed(99), cfg)
    path = str(tmp_path / "weights.pv")
    params_io.save_params(path, params, cfg)
    tree, file_cfg = params_io.load_params(path)
    assert set(tree["encoder"][0]) == {"0", "2"}
    loaded = params_io.params_from_numpy(tree, "cpu", "demucs", file_cfg)
    for k, v in params.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v.half().float()), k


def _process(path, pcm):
    k = koala_tpu_torch.create(ACCESS_KEY, model_path=path, device="cpu")
    try:
        return np.concatenate([k.process(pcm[s:s + 256]) for s in range(0, len(pcm), 256)])
    finally:
        k.delete()


@pytest.fixture(scope="module")
def pcm():
    return np.clip(np.round(_hops(3, 24, seed=9).reshape(3, -1).numpy() * 32768.0),
                   -32768, 32767).astype(np.int16)


def test_entry_points_agree_with_process(model_file, pcm):
    """Koala.process frame by frame is the reference of the others: Koala.enhance
    and KoalaBatch.enhance (the input padded by the 768-sample delay, the
    output trimmed by it), KoalaBatch.process_chunk, CorpusRunner."""
    want = [_process(model_file, row) for row in pcm]
    delay = 768
    k = koala_tpu_torch.create(ACCESS_KEY, model_path=model_file, device="cpu")
    try:
        assert k.delay_sample == delay
        got = k.enhance(pcm[0, :-delay])
        assert np.array_equal(got, want[0][delay:])
    finally:
        k.delete()
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, model_path=model_file, batch_size=3,
                                      device="cpu")
    try:
        assert kb.delay_sample == delay
        assert np.array_equal(kb.process_chunk(pcm), np.stack(want))
        kb.reset()
        got = kb.enhance(pcm[:, :-delay])
        assert np.array_equal(got, np.stack(want)[:, delay:])
    finally:
        kb.delete()
    runner = CorpusRunner(model_file, global_batch=3, utterance_samples=pcm.shape[1],
                          mesh=make_mesh(["cpu"]))
    out = runner.enhance_batch(pcm.astype(np.float32) / 32768.0)
    rows = np.clip(np.round(out.reshape(3, -1).numpy().astype(np.float64) * 32768.0),
                   -32768, 32767).astype(np.int16)
    assert np.array_equal(rows, np.stack(want))


def test_server_agrees_with_process(model_file, pcm):
    """StreamingServer: full chunks through the sequence, the rest through the
    masked step, against Koala.process bit for bit; its delay the model's."""
    want = [_process(model_file, row) for row in pcm[:2]]
    server = StreamingServer(ACCESS_KEY, model_path=model_file, device="cpu", num_streams=2,
                             chunk_frames=4)
    try:
        assert server.delay_sample == 768
        for s in range(2):
            server.push(s, pcm[s, :(5 + 6 * s) * 256])
        time.sleep(0.3)
        for s in range(2):
            server.push(s, pcm[s, (5 + 6 * s) * 256:])
        for s in range(2):
            got, deadline = [], time.time() + 60
            while sum(len(g) for g in got) < pcm.shape[1] and time.time() < deadline:
                chunk = server.pull(s)
                if len(chunk):
                    got.append(chunk)
                else:
                    time.sleep(0.005)
            assert np.array_equal(np.concatenate(got), want[s]), s
    finally:
        server.close()


def test_snapshot_mid_stream(model_file, pcm):
    """save_state / load_state carry a stream across objects mid-stream."""
    want = _process(model_file, pcm[0])
    a = koala_tpu_torch.create(ACCESS_KEY, model_path=model_file, device="cpu")
    b = koala_tpu_torch.create(ACCESS_KEY, model_path=model_file, device="cpu")
    try:
        head = [a.process(pcm[0, s:s + 256]) for s in range(0, 10 * 256, 256)]
        b.load_state(a.save_state())
        tail = [b.process(pcm[0, s:s + 256]) for s in range(10 * 256, pcm.shape[1], 256)]
        assert np.array_equal(np.concatenate(head + tail), want)
    finally:
        a.delete()
        b.delete()


# -- the LSTM kernel at Demucs's depth ------------------------------------------


def test_plain_lstm_cell_at_depth_2048():
    """The plain version at kx 1024, H 1024 against the cell's equations on
    PyTorch's [4H, in] weights (bf16 operands, f32 sums)."""
    g = torch.Generator().manual_seed(1)
    h = 1024
    w_ih, w_hh = ((torch.rand(4 * h, h, generator=g) * 2 - 1) / 32 for _ in range(2))
    b_ih, b_hh = ((torch.rand(4 * h, generator=g) * 2 - 1) / 32 for _ in range(2))
    w, b = lstm.stack_weights(w_ih, w_hh, b_ih, b_hh)
    assert tuple(w.shape) == (4 * h, 2048)
    x, h0, c0 = (torch.randn(5, h, generator=g) for _ in range(3))
    h1, c1 = lstm.lstm_cell(x, h0, c0, w, b)
    r = lambda t: t.bfloat16().float()  # noqa: E731
    gates = r(x) @ r(w_ih).t() + r(h0) @ r(w_hh).t() + b_ih + b_hh
    i, f, gg, o = gates.chunk(4, dim=-1)
    c_want = torch.sigmoid(f) * c0 + torch.sigmoid(i) * torch.tanh(gg)
    assert (c1 - c_want).abs().max() < 1e-4
    assert (h1 - torch.sigmoid(o) * torch.tanh(c_want)).abs().max() < 1e-4


def test_lstm_tile_plan_at_depth_2048_and_fullsubnets_unchanged():
    """Depth 2048: 64-row tiles holding 1024 of the depth (K-panels), the
    passes split so that 2048 rows' items fit the clusters in one round.
    FullSubNet's four widths: their whole depth in the tile, their plans as
    before."""
    assert lstm.tile_rows(1024, 1024) == 64 and lstm.tile_depth(1024, 1024) == 1024
    assert lstm.plan(2048, 1024, 1024) == (64, 8, 4)
    assert lstm.plan(1, 1024, 1024) == (64, 1, 32)
    for (kx, h), rows, p in (((32, 384), 128, (128, 2, 6)), ((384, 384), 128, (128, 2, 6)),
                             ((257, 512), 64, (64, 4, 4)), ((512, 512), 64, (64, 4, 4))):
        assert lstm.tile_rows(kx, h) == rows and lstm.tile_depth(kx, h) == lstm.padded(kx) + h
        assert lstm.plan(2048, kx, h) == p, (kx, h)
