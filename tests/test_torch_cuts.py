"""A stream's output against how it is cut into calls, on the CPU: the
fixed-order product's wrapper (ops/kernels/rowmm.py) and its route through
the nine frame-local products, the step through the GRU stack at T = 1 on
the kernel branch, and the port's default CPU route against koala_tpu."""

import json
import os

import numpy as np
import pytest
import torch

import koala_tpu
import koala_tpu_torch
from koala_tpu_torch.constants import FRAME_LENGTH
from koala_tpu_torch.engine.core import Engine, make_engine
from koala_tpu_torch.engine.stream import load_model
from koala_tpu_torch.io import read_wav
from koala_tpu_torch.models import mask_gru as tmask
from koala_tpu_torch.models import mmse, params_io
from koala_tpu_torch.ops.kernels import rowmm

from torch_ref import ACCESS_KEY, assert_near_jax

AUDIO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "resources", "audio_samples")
# (K, N) of the nine frame-local products of the bundled model, in the order
# a sequence call makes them: the STFT's two bases, the band pool, the
# cepstral basis, the encoder, decoder and gate, the iSTFT's two bases
NINE = [(512, 257), (512, 257), (257, 32), (257, 161), (329, 384), (384, 257), (384, 1),
        (257, 512), (257, 512)]
# streams of the bit-for-bit tests on the CPU route: at 32 streams every
# round's element count is a whole multiple of the CPU's vector width, and
# PyTorch's vectorised sigmoid and tanh-gelu, whose scalar loop rounds the
# last elements of a tensor otherwise, treat every element alike. A card's
# elementwise kernels do so at any count (tests/test_torch_cuda.py holds the
# round shapes there at 5 and 6 streams)
CUT_B, CUT_T = 32, 40


def _hops(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32))


def _mix(batch, n):
    """``batch`` streams of the committed synth speech + noise mix, each from
    another offset (the bundled model is held to koala_tpu on speech)."""
    speech = read_wav(os.path.join(AUDIO, "speech_synth.wav")).astype(np.int32)
    noise = read_wav(os.path.join(AUDIO, "noise_synth.wav")).astype(np.int32)
    m = min(len(speech), len(noise))
    mix = np.clip(speech[:m] + noise[:m], -32768, 32767).astype(np.int16)
    return np.stack([mix[i * 9001:i * 9001 + n] for i in range(batch)])


@pytest.fixture(scope="module")
def mmse_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cuts") / "mmse.pv")
    params_io.save_params(path, mmse.init_params(), mmse.DEFAULT_CONFIG)
    return path


def _kernel_branch(model_path=None):
    """A model's engine with the kernel branch forced: on the CPU the
    kernels' plain versions, the route a card takes."""
    engine, params = load_model(model_path or params_io.default_model_path(), "cpu")
    return Engine(engine.kind, dict(engine.config, use_pallas=True)), params


class _Spy:
    """Keeps the shape of the second argument of every call of
    ``module.name`` and passes the call on."""

    def __init__(self, monkeypatch, module, name):
        self.shapes = []
        orig = getattr(module, name)

        def wrapped(a, b, *args, **kwargs):
            self.shapes.append(tuple(b.shape))
            return orig(a, b, *args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)


# ---- the wrapper

def test_rowmm_takes_the_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper is its plain version (no launch counted),
    torch.matmul within float32 rounding, for any batch axes."""
    a, b = _hops(0, (2, 5, 33), 1.0), _hops(1, (33, 7), 1.0)
    before = rowmm.launches
    got = rowmm.rowmm(a, b)
    assert rowmm.launches == before
    assert torch.equal(got, rowmm.rowmm_ref(a, b)) and got.shape == (2, 5, 7)
    np.testing.assert_allclose(got.numpy(), (a @ b).numpy(), rtol=1e-5, atol=1e-5)
    assert rowmm.rowmm(a[:0], b).shape == (0, 5, 7)


@pytest.mark.parametrize("k,n", sorted(set(NINE)) + [(384, 1152)])
def test_rowmm_plain_version_row_bits_do_not_depend_on_the_rows(k, n):
    """The plain version keeps the kernel's promise on the CPU: a row has the
    same bits at 1, 3, 17 and 100 rows and wherever it lies in a block."""
    a, b = _hops(2, (120, k), 1.0), _hops(3, (k, n), 0.1)
    full = rowmm.rowmm(a, b)
    for m in (1, 3, 17, 100):
        for start in (0, 5, 16, 120 - m):
            assert torch.equal(rowmm.rowmm(a[start:start + m], b), full[start:start + m]), \
                (m, start)


@pytest.mark.parametrize("a_shape,b_shape,dtype", [
    ((4, 8), (7, 3), torch.float32),           # K does not match
    ((4, 8), (8,), torch.float32),             # b not [K, N]
    ((4, 8), (8, 3, 1), torch.float32),
    ((4, 8), (8, 3), torch.float64),           # not float32
    ((4, 8), (8, 3), torch.bfloat16),
])
def test_rowmm_raises_on_bad_shapes_and_dtypes(a_shape, b_shape, dtype):
    a = torch.zeros(a_shape, dtype=dtype)
    b = torch.zeros(b_shape, dtype=dtype)
    with pytest.raises(ValueError):
        rowmm.rowmm(a, b)


# the names of the fixed-order product's kernels in a trace (csrc/rowmm.cu)
ROWMM_TRACE_NAMES = [
    "void (anonymous namespace)::rowmm_narrow_kernel<4, 128, 4>((anonymous namespace)::RowsOfA, "
    "float const*, float*, int, int, int)",
    "void (anonymous namespace)::rowmm_row_kernel<4, 4>((anonymous namespace)::RowsOfA, "
    "float const*, float*, int, int, int)",
    "(anonymous namespace)::rowmm_col_kernel((anonymous namespace)::RowsOfA, float const*, "
    "float*, int, int, long long)",
    "void (anonymous namespace)::rowmm_tile_kernel<128, 64, 8, 8, 16, 3>((anonymous "
    "namespace)::RowsOfA, float const*, float*, int, int, int, long long)",
    "(anonymous namespace)::rowmm_simple_kernel(float const*, float const*, float*, int, int, "
    "int)",
]


@pytest.mark.parametrize("name", ROWMM_TRACE_NAMES,
                         ids=["narrow", "row", "col", "tile", "simple"])
def test_census_counts_rowmm_as_a_port_kernel(tmp_path, name):
    """scripts/bench_sweep_torch.py's census groups every kernel of the
    fixed-order product with the port's kernels, not with the GEMMs."""
    import importlib.util

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench_sweep_torch", os.path.join(here, "scripts", "bench_sweep_torch.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    events = [{"ph": "X", "cat": "kernel", "dur": 12, "name": name},
              {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32_f32f32", "dur": 9}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    groups = sweep.census_of_trace(str(path))
    assert (groups["port"]["count"], groups["gemm"]["count"]) == (1, 1)


# ---- the route of the nine products

@pytest.mark.parametrize("entry", ["sequence", "step"])
def test_the_nine_products_go_through_the_wrapper_under_inference_mode(monkeypatch, entry):
    """Under inference mode every frame-local product of the bundled model
    (kernel branch: the GRU stack is one wrapper call) goes through rowmm, in
    sequence and step alike, and none through torch.matmul directly."""
    engine, params = _kernel_branch()
    spy = _Spy(monkeypatch, rowmm, "rowmm")
    direct = _Spy(monkeypatch, torch, "matmul")
    hops = _hops(4, (3, 5, FRAME_LENGTH))
    with torch.inference_mode():
        state = engine.init_state((3,), "cpu")
        if entry == "sequence":
            engine.sequence(params, state, hops)
        else:
            engine.step(params, state, hops[:, 0])
    assert spy.shapes == NINE
    # the plain version's own torch.matmul calls: one a block of rows
    assert set(direct.shapes) <= set(NINE) | {(384, 2)}


def test_the_scan_branch_projections_go_through_the_wrapper(monkeypatch):
    """On the scan branch (the CPU's default) the GRU's wx and wh products
    go through rowmm too: one wx product a layer and call, one wh product a
    layer and frame."""
    engine, params = load_model(params_io.default_model_path(), "cpu")
    spy = _Spy(monkeypatch, rowmm, "rowmm")
    with torch.inference_mode():
        engine.sequence(params, engine.init_state((3,), "cpu"), _hops(5, (3, 4, FRAME_LENGTH)))
    gru = [s for s in spy.shapes if s == (384, 1152)]
    assert len(gru) == 2 + 2 * 4
    assert [s for s in spy.shapes if s != (384, 1152)] == NINE


def test_mmse_products_go_through_the_wrapper(monkeypatch, mmse_path):
    engine, params = load_model(mmse_path, "cpu")
    spy = _Spy(monkeypatch, rowmm, "rowmm")
    with torch.inference_mode():
        engine.sequence(params, engine.init_state((2,), "cpu"), _hops(6, (2, 3, FRAME_LENGTH)))
    assert spy.shapes == [(512, 257), (512, 257), (257, 512), (257, 512)]


def test_a_recorded_graph_takes_torch_matmul(monkeypatch):
    """Where autograd records a graph of a product (weights that take a
    gradient, and here input hops that do too) the product is torch.matmul,
    as before: the training path's numbers do not move. A product that
    records no graph (the STFT of audio that takes no gradient) stays on
    rowmm."""
    engine, params = load_model(params_io.default_model_path(), "cpu")
    params.requires_grad_(True)
    spy = _Spy(monkeypatch, rowmm, "rowmm")
    direct = _Spy(monkeypatch, torch, "matmul")
    hops = _hops(7, (2, 4, FRAME_LENGTH)).requires_grad_(True)
    _, out = engine.sequence(params, engine.init_state((2,), "cpu"), hops)
    out.square().sum().backward()
    assert spy.shapes == []
    assert [s for s in direct.shapes if s != (384, 1152)] == NINE
    assert params.enc.w.grad is not None and hops.grad is not None
    spy.shapes.clear()
    direct.shapes.clear()
    _, out = engine.sequence(params, engine.init_state((2,), "cpu"), hops.detach())
    assert spy.shapes == [(512, 257), (512, 257), (257, 32), (257, 161)]
    # beside the plain version's own calls, one a block of rows
    assert {(329, 384), (384, 257), (384, 1), (257, 512)} <= set(direct.shapes)


# ---- the step through the GRU stack at T = 1

def test_step_calls_gru_stack_at_t1_on_the_kernel_branch(monkeypatch):
    """Under use_pallas=True the step runs the stack as one gru_stack call at
    T = 1 (its plain version on the CPU), never the scan's step; an
    unbatched frame (Koala.process) is a batch of one."""
    engine, params = _kernel_branch()
    calls = []
    orig = tmask.gru_stack

    def spy(h0, x, *weights):
        calls.append((tuple(h0.shape), tuple(x.shape), x.dtype))
        return orig(h0, x, *weights)

    def refuse(*args, **kwargs):
        raise AssertionError("the scan's step ran on the kernel branch")

    monkeypatch.setattr(tmask, "gru_stack", spy)
    monkeypatch.setattr(tmask, "_gru_recurrent", refuse)
    hops = _hops(8, (3, FRAME_LENGTH))
    with torch.inference_mode():
        state, out = engine.step(params, engine.init_state((3,), "cpu"), hops)
        single, out1 = engine.step(params, engine.init_state((), "cpu"), hops[1])
    assert calls == [((2, 3, 384), (1, 3, 384), torch.bfloat16),
                     ((2, 1, 384), (1, 1, 384), torch.bfloat16)]
    assert state["model"]["h"].shape == (3, 2, 384) and single["model"]["h"].shape == (2, 384)
    assert out.shape == (3, FRAME_LENGTH) and out1.shape == (FRAME_LENGTH,)


@pytest.mark.parametrize("model", ["mask_gru", "mmse"])
def test_round_shapes_agree_bit_for_bit_on_the_kernel_branch(mmse_path, model):
    """The CPU route that mirrors the card: one sequence call over 40 frames,
    rounds of 1, 8 and 32 frames and 40 steps give the same output and
    state, bit for bit; so do one apply_sequence call and 40 model steps."""
    engine, params = _kernel_branch(None if model == "mask_gru" else mmse_path)
    hops = _hops(9, (CUT_B, CUT_T, FRAME_LENGTH))
    def same(a, b):
        fa, fb = params_io._flatten(a), params_io._flatten(b)
        return fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)

    with torch.inference_mode():
        state, one = engine.sequence(params, engine.init_state((CUT_B,), "cpu"), hops)
        for r in (1, 8, 32):
            st, outs = engine.init_state((CUT_B,), "cpu"), []
            for j in range(0, CUT_T, r):
                st, o = engine.sequence(params, st, hops[:, j:j + r])
                outs.append(o)
            assert torch.equal(torch.cat(outs, 1), one), r
            assert same(st, state), r
        st, outs = engine.init_state((CUT_B,), "cpu"), []
        for j in range(CUT_T):
            st, o = engine.step(params, st, hops[:, j])
            outs.append(o)
        assert torch.equal(torch.stack(outs, 1), one)
        assert same(st, state)
        if model == "mask_gru":
            cfg = engine.config
            frames = torch.cat([torch.zeros_like(hops[:, :1]), hops[:, :-1]], 1)
            re, im = koala_tpu_torch.ops.stft_frame(torch.cat([frames, hops], -1))
            m_state, masks = tmask.apply_sequence(params, tmask.init_state((CUT_B,), cfg, "cpu"),
                                                  re, im, cfg)
            s, ms = tmask.init_state((CUT_B,), cfg, "cpu"), []
            for j in range(CUT_T):
                s, mj = tmask.step(params, s, re[:, j], im[:, j], cfg)
                ms.append(mj)
            assert torch.equal(torch.stack(ms, 1), masks)
            assert torch.equal(s["h"], m_state["h"]) and torch.equal(s["floor"], m_state["floor"])


def test_a_model_without_a_plan_takes_the_scan_in_step_and_sequence(monkeypatch, caplog):
    """Hidden 768 x 3 has no GRU launch plan: on the kernel branch the step
    and the sequence both run the scan (no gru_stack call) with one warning
    between them, and agree through the fixed-order products."""
    cfg = dict(tmask.TRAIN_CONFIG, hidden=768, num_layers=3, use_pallas=True)
    params = tmask.init_params(torch.Generator().manual_seed(5), cfg)
    engine = make_engine("mask_gru", cfg)
    monkeypatch.setattr(tmask, "_FALLBACK_WARNED", set())
    calls = []

    def refuse(*args, **kwargs):
        calls.append(1)
        raise AssertionError("gru_stack was called without a launch plan")

    monkeypatch.setattr(tmask, "gru_stack", refuse)
    hops = _hops(10, (CUT_B, 3, FRAME_LENGTH), 0.05)
    with caplog.at_level("WARNING", logger="koala_tpu_torch"), torch.inference_mode():
        _, one = engine.sequence(params, engine.init_state((CUT_B,), "cpu"), hops)
        st, outs = engine.init_state((CUT_B,), "cpu"), []
        for j in range(3):
            st, o = engine.step(params, st, hops[:, j])
            outs.append(o)
    warned = [r for r in caplog.records if "GRU kernel DISABLED" in r.getMessage()]
    assert not calls and len(warned) == 1
    assert torch.equal(torch.stack(outs, 1), one)


# ---- the default CPU route against koala_tpu

@pytest.mark.parametrize("entry", ["process_chunk", "process"])
def test_default_cpu_route_meets_koala_tpu(entry):
    """The port's default CPU route (the scan) against koala_tpu on the
    bundled model and the committed speech mix, step and sequence:
    ``assert_near_jax`` on every stream."""
    pcm = _mix(3, 40 * FRAME_LENGTH)
    out = []
    for pkg in (koala_tpu_torch, koala_tpu):
        kb = pkg.create_batch(ACCESS_KEY, batch_size=3, device="cpu")
        if entry == "process_chunk":
            out.append(np.asarray(kb.process_chunk(pcm)))
        else:
            out.append(np.concatenate([np.asarray(kb.process(pcm[:, s:s + FRAME_LENGTH]))
                                       for s in range(0, pcm.shape[1], FRAME_LENGTH)], axis=1))
        kb.delete()
    for got, want in zip(*out):
        assert_near_jax(got, want)
