"""Models of the port (models/mask_gru.py, mmse.py, identity.py, params_io.py)
against koala_tpu on the same weights and spectra."""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koala_tpu.models import mask_gru as jmask
from koala_tpu.models import mmse as jmmse
from koala_tpu.models import params_io as jio
from koala_tpu.ops import stft as jstft
from koala_tpu_torch.constants import FRAME_LENGTH
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models import mask_gru as tmask
from koala_tpu_torch.models import mmse as tmmse
from koala_tpu_torch.models import params_io as tio
from koala_tpu_torch.models.base import Placeholder
from koala_tpu_torch.models.registry import MODEL_REGISTRY, kind_of

from torch_ref import jax_params, to_numpy

CONFIGS = {"train": jmask.TRAIN_CONFIG, "default": jmask.DEFAULT_CONFIG}
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "rms_profiles.json")
# tests/test_engine.py's step-vs-sequence state tolerance (rtol 1e-4,
# atol 3e-5), with atol 1e-4: the two packages' f32 sums run in another
# order (BLAS vs XLA), and a last-bit difference can flip one bf16 rounding
# of a product operand, which moves a small hidden unit by up to ~1e-4 -
# far inside tests/test_pallas_gru.py's bf16 cross-path atol 4e-2.
# Measured: masks within 1.1e-5, h within 7.0e-5, floor within 6e-8.
RTOL, ATOL = 1e-4, 1e-4


def _spectra(seed, b=4, t=10):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((b, t, 512)) * 0.1).astype(np.float32)
    re, im = jstft.stft_frame(jnp.asarray(frames))
    return np.array(re), np.array(im)


def _both(kind, seed):
    cfg = CONFIGS[kind]
    tree = jax_params(cfg, seed)
    return cfg, tree, jax.tree_util.tree_map(jnp.asarray, tree), \
        tio.params_from_numpy(tree, "cpu")


def _assert_states_close(t_state, j_state):
    a, b = to_numpy(t_state), to_numpy(jax.tree_util.tree_map(np.asarray, j_state))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL, err_msg=k)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_apply_sequence_matches_jax(kind):
    cfg, _, jp, tp = _both(kind, 1)
    re, im = _spectra(0)
    j_state, j_mask = jmask.apply_sequence(jp, jmask.init_state((4,), cfg),
                                           jnp.asarray(re), jnp.asarray(im), cfg)
    t_state, t_mask = tmask.apply_sequence(tp, tmask.init_state((4,), cfg, "cpu"),
                                           torch.as_tensor(re), torch.as_tensor(im), cfg)
    np.testing.assert_allclose(t_mask.numpy(), np.asarray(j_mask), rtol=RTOL, atol=ATOL)
    _assert_states_close(t_state, j_state)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_step_matches_jax(kind):
    cfg, _, jp, tp = _both(kind, 2)
    re, im = _spectra(1, t=3)
    j_state, t_state = jmask.init_state((4,), cfg), tmask.init_state((4,), cfg, "cpu")
    for i in range(3):
        j_state, j_mask = jmask.step(jp, j_state, jnp.asarray(re[:, i]),
                                     jnp.asarray(im[:, i]), cfg)
        t_state, t_mask = tmask.step(tp, t_state, torch.as_tensor(re[:, i]),
                                     torch.as_tensor(im[:, i]), cfg)
        np.testing.assert_allclose(t_mask.numpy(), np.asarray(j_mask), rtol=RTOL, atol=ATOL)
    _assert_states_close(t_state, j_state)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_kernel_branch_matches_scan_branch(kind):
    """use_pallas=True routes apply_sequence through the floor and GRU
    wrappers (their plain versions on the CPU). The GRU kernel streams x as
    bf16, one rounding more than the scan: measured mask difference 5.6e-5,
    held at 2e-4 (far inside tests/test_pallas_gru.py's 4e-2)."""
    cfg, _, _, tp = _both(kind, 3)
    re, im = _spectra(2)
    args = (torch.as_tensor(re), torch.as_tensor(im))
    s_state, s_mask = tmask.apply_sequence(tp, tmask.init_state((4,), cfg, "cpu"), *args, cfg)
    k_state, k_mask = tmask.apply_sequence(tp, tmask.init_state((4,), cfg, "cpu"), *args,
                                           dict(cfg, use_pallas=True))
    np.testing.assert_allclose(k_mask.numpy(), s_mask.numpy(), atol=2e-4)
    if isinstance(s_state, dict):
        assert torch.equal(k_state["floor"], s_state["floor"])
        s_state, k_state = s_state["h"], k_state["h"]
    np.testing.assert_allclose(k_state.numpy(), s_state.numpy(), atol=1e-3)


def test_bundled_model_loads_as_in_jax():
    path = tio.default_model_path()
    t_tree, t_cfg = tio.load_params(path)
    j_tree, j_cfg = jio.load_params(path)
    assert t_cfg == j_cfg
    t_flat, j_flat = tio._flatten(t_tree), jio._flatten(j_tree)
    assert set(t_flat) == set(j_flat)
    for k in t_flat:
        assert t_flat[k].dtype == np.float32
        np.testing.assert_array_equal(t_flat[k], j_flat[k])
    module = tio.params_from_numpy(t_tree, "cpu")
    assert set(module.state_dict()) == {k.replace("/", ".") for k in t_flat}
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), t_flat[k.replace(".", "/")])


@pytest.mark.parametrize("weights", ["train_config", "bundled"])
def test_num_params_matches_jax(weights):
    """The same count as koala_tpu's num_params on the same weights, in the
    1.5M-2.5M band that tests/test_engine.py pins."""
    if weights == "bundled":
        tree, _ = jio.load_params(tio.default_model_path())
    else:
        tree = jax_params(jmask.TRAIN_CONFIG, 0)
    n = tmask.num_params(tio.params_from_numpy(tree, "cpu"))
    assert n == jmask.num_params(tree)
    assert 1_500_000 < n < 2_500_000, n


def test_save_params_round_trip(tmp_path):
    tree = jax_params(jmask.TRAIN_CONFIG, 5)
    module = tio.params_from_numpy(tree, "cpu")
    path = str(tmp_path / "m.pv")
    tio.save_params(path, module, jmask.TRAIN_CONFIG)
    j_tree, j_cfg = jio.load_params(path)          # the JAX package reads it
    t_tree, t_cfg = tio.load_params(path)
    assert t_cfg == j_cfg == jmask.normalize_config(jmask.TRAIN_CONFIG)
    for k, v in tio._flatten(t_tree).items():
        np.testing.assert_array_equal(v, jio._flatten(j_tree)[k])
        np.testing.assert_array_equal(
            v, np.asarray(jio._flatten(tree)[k], np.float16).astype(np.float32))


def test_normalize_config_infers_legacy_layouts():
    for cfg in (jmask.DEFAULT_CONFIG, jmask.TRAIN_CONFIG,
                dict(jmask.DEFAULT_CONFIG, snr_bands=32)):
        enc = {"enc": {"w": np.zeros((jmask.expected_enc_in(cfg), 8))}}
        assert tmask.normalize_config({}, enc) == jmask.normalize_config({}, enc)
    with pytest.raises(ValueError):
        tmask.normalize_config({}, {"enc": {"w": np.zeros((3, 8))}})


def _golden_profile(kind, tree, cfg):
    rng = np.random.default_rng(424242)
    t = 40
    tt = np.arange(t * FRAME_LENGTH) / 16000.0
    sig = 0.2 * np.sin(2 * np.pi * 440 * tt) * (np.sin(2 * np.pi * 1.5 * tt) > 0)
    sig = sig + rng.standard_normal(t * FRAME_LENGTH) * 0.02
    hops = torch.as_tensor(sig.astype(np.float32).reshape(1, t, FRAME_LENGTH))
    engine = make_engine(kind, cfg)
    params = tio.params_from_numpy(tree, "cpu", kind)
    _, out = engine.sequence(params, engine.init_state((1,), "cpu"), hops)
    out = out.numpy().reshape(t, FRAME_LENGTH)
    return [float(np.sqrt(np.mean(f ** 2))) for f in out]


@pytest.mark.parametrize("kind", ["identity", "mmse", "mask_gru"])
def test_golden_profiles(kind):
    """tests/golden/rms_profiles.json, with the weights of
    init_params(PRNGKey(0)) (tests/test_golden.py), atol 2e-3."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[kind]
    if kind == "identity":
        from koala_tpu.models import identity
        tree, cfg = {"empty": np.zeros((1,), np.float32)}, identity.DEFAULT_CONFIG
    elif kind == "mmse":
        tree, cfg = {"empty": np.zeros((1,), np.float32)}, jmmse.DEFAULT_CONFIG
    else:
        tree, cfg = jax_params(jmask.DEFAULT_CONFIG, 0), jmask.DEFAULT_CONFIG
    got = _golden_profile(kind, tree, cfg)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=2e-3)


# mmse: a straight transcription; XLA's fusion reorders a few operations, so
# most values agree bit for bit and the rest within float32 rounding
# (measured mask max |err| 7.2e-7 at B = 4, T = 200).
MMSE_ATOL = 1e-5


def _mmse_spectra(seed, t):
    rng = np.random.default_rng(seed)
    # loud and quiet stretches, so that the gain leaves its floor and the
    # noise tracker both adapts and holds
    env = np.where((np.arange(t) // 25) % 2 == 0, 0.02, 0.3).astype(np.float32)
    frames = rng.standard_normal((4, t, 512)).astype(np.float32) * env[None, :, None]
    re, im = jstft.stft_frame(jnp.asarray(frames))
    return np.array(re), np.array(im)


def _assert_mmse_states_close(t_state, j_state):
    assert set(t_state) == set(j_state) == {"noise", "prev_gain2_post", "count"}
    for k in t_state:
        # 1e-5 relative to the leaf's scale: a posterior SNR near 1e-18
        # differs by a few float32 roundings of the terms around it
        ref = np.asarray(j_state[k])
        np.testing.assert_allclose(t_state[k].numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=k)


def test_mmse_apply_sequence_matches_jax():
    re, im = _mmse_spectra(7, 200)
    cfg = jmmse.DEFAULT_CONFIG
    j_state, j_mask = jmmse.apply_sequence(jmmse.init_params(), jmmse.init_state((4,), cfg),
                                           jnp.asarray(re), jnp.asarray(im), cfg)
    t_state, t_mask = tmmse.apply_sequence(tmmse.init_params(),
                                           tmmse.init_state((4,), cfg, "cpu"),
                                           torch.as_tensor(re), torch.as_tensor(im), cfg)
    assert t_mask.shape == (4, 200, 257)
    np.testing.assert_allclose(t_mask.numpy(), np.asarray(j_mask), rtol=0, atol=MMSE_ATOL)
    assert float(t_mask.max()) > 0.5 and float(t_mask.min()) == np.float32(cfg["gain_floor"])
    _assert_mmse_states_close(t_state, j_state)


def test_mmse_step_matches_jax():
    re, im = _mmse_spectra(8, 30)
    cfg = jmmse.DEFAULT_CONFIG
    j_state, t_state = jmmse.init_state((4,), cfg), tmmse.init_state((4,), cfg, "cpu")
    for i in range(re.shape[1]):
        j_state, j_mask = jmmse.step(None, j_state, jnp.asarray(re[:, i]),
                                     jnp.asarray(im[:, i]), cfg)
        t_state, t_mask = tmmse.step(None, t_state, torch.as_tensor(re[:, i]),
                                     torch.as_tensor(im[:, i]), cfg)
        np.testing.assert_allclose(t_mask.numpy(), np.asarray(j_mask), rtol=0, atol=MMSE_ATOL)
    _assert_mmse_states_close(t_state, j_state)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mmse_model_file_crosses_packages(writer, tmp_path):
    """An mmse ``.pv`` written by either package loads in both, and the
    port's loader builds the mmse parameter module from its kind."""
    from koala_tpu_torch.engine.stream import load_model

    path = str(tmp_path / "mmse.pv")
    if writer == "jax":
        jio.save_params(path, jmmse.init_params(), jmmse.DEFAULT_CONFIG)
    else:
        tio.save_params(path, tmmse.init_params(), tmmse.DEFAULT_CONFIG)
    j_tree, j_cfg = jio.load_params(path)
    t_tree, t_cfg = tio.load_params(path)
    assert t_cfg == j_cfg == jmmse.DEFAULT_CONFIG
    np.testing.assert_array_equal(t_tree["empty"], np.asarray(j_tree["empty"]))
    engine, params = load_model(path, "cpu")
    assert engine.kind == "mmse" and isinstance(params, tmmse.MMSE)
    assert isinstance(tio.params_from_numpy(t_tree, "cpu", "mmse"), tmmse.MMSE)


def test_mmse_serves_through_create_and_create_batch(tmp_path):
    """An mmse model file through the public surface of both packages: the
    same enhanced audio within 2 LSB (tests/test_serve.py's bound)."""
    import koala_tpu
    import koala_tpu_torch

    from torch_ref import ACCESS_KEY

    path = str(tmp_path / "mmse.pv")
    jio.save_params(path, jmmse.init_params(), jmmse.DEFAULT_CONFIG)
    rng = np.random.default_rng(9)
    pcm = (rng.standard_normal((2, 20 * FRAME_LENGTH)) * 4000).astype(np.int16)
    want = np.asarray(koala_tpu.create(ACCESS_KEY, model_path=path, device="cpu").enhance(pcm[0]))
    got = koala_tpu_torch.create(ACCESS_KEY, model_path=path, device="cpu").enhance(pcm[0])
    assert np.abs(got.astype(np.int32) - want).max() <= 2
    jb = koala_tpu.create_batch(ACCESS_KEY, batch_size=2, model_path=path, device="cpu")
    tb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=2, model_path=path, device="cpu")
    out = tb.process_chunk(pcm)
    assert np.any(out != 0)
    assert np.abs(out.astype(np.int32) - np.asarray(jb.process_chunk(pcm))).max() <= 2


def test_identity_init_params_matches_jax():
    """``identity.init_params`` as koala_tpu's: the one zero placeholder,
    and an engine on it is a pure delay."""
    from koala_tpu.models import identity as jidentity
    from koala_tpu_torch.models import identity as tidentity

    mine = tidentity.init_params(None, tidentity.DEFAULT_CONFIG)
    theirs = jidentity.init_params(jax.random.PRNGKey(0), jidentity.DEFAULT_CONFIG)
    assert isinstance(mine, tidentity.Identity)
    assert {k for k, _ in mine.named_parameters()} == set(theirs)
    np.testing.assert_array_equal(mine.empty.detach().numpy(), np.asarray(theirs["empty"]))
    engine = make_engine("identity", tidentity.DEFAULT_CONFIG)
    hops = torch.randn((3, FRAME_LENGTH), generator=torch.Generator().manual_seed(1)) * 0.1
    _, out = engine.sequence(mine, engine.init_state((), "cpu"), hops)
    torch.testing.assert_close(out.reshape(-1)[FRAME_LENGTH:], hops.reshape(-1)[:-FRAME_LENGTH],
                               atol=1e-6, rtol=0)


# -- the model seam: every kind through the registry alone ---------------------


@pytest.mark.parametrize("kind", sorted(MODEL_REGISTRY))
def test_every_kind_round_trips_through_the_model_file(kind, tmp_path):
    """init_params -> save_params -> load_params -> params_from_numpy gives
    the registry's parameter class with the weights (as float16 rounds them)
    and the config: byte-equal for every kind but mask_gru, whose config is
    reconciled with its weights (test_normalize_config_infers_legacy_layouts)."""
    model = MODEL_REGISTRY[kind]
    cfg = model.DEFAULT_CONFIG
    params = model.init_params(torch.Generator().manual_seed(3), cfg)
    path = str(tmp_path / ("%s.pv" % kind))
    tio.save_params(path, params, cfg)
    tree, loaded_cfg = tio.load_params(path)
    if kind == "mask_gru":
        assert loaded_cfg == tmask.normalize_config(cfg, tree)
    else:
        assert json.dumps(loaded_cfg) == json.dumps(cfg)
    assert kind_of(loaded_cfg) == kind
    back = tio.params_from_numpy(tree, "cpu", kind)
    assert type(back) is model.Params
    want = params.state_dict()
    assert set(back.state_dict()) == set(want)
    for k, v in back.state_dict().items():
        assert torch.equal(v, want[k].half().float()), k


def _toy_model():
    """A model kind that no module of the package knows: no weights, no
    state, a constant real mask of 0.5."""
    toy = types.ModuleType("toy_model")
    toy.DEFAULT_CONFIG = {"kind": "toy"}
    toy.Params = Placeholder
    toy.init_params = lambda generator=None, config=None: Placeholder()
    toy.init_state = lambda batch_shape, config, device: torch.zeros(
        tuple(batch_shape) + (1,), device=torch.device(device))
    toy.step = toy.apply_sequence = lambda params, state, re, im, config=None: (
        state, torch.full_like(re, 0.5))
    return toy


def test_a_kind_registered_alone_runs_through_every_entry_point(tmp_path, monkeypatch):
    """A new kind is one module and one registry entry: registered through the
    registry alone, the toy kind loads from its model file and halves its
    input through ``create_batch(...).enhance``, ``Koala.process`` and
    ``CorpusRunner.enhance_batch``."""
    import koala_tpu_torch
    from koala_tpu_torch.models import registry
    from koala_tpu_torch.parallel.mesh import make_mesh
    from koala_tpu_torch.parallel.runner import CorpusRunner

    from torch_ref import ACCESS_KEY

    toy = _toy_model()
    monkeypatch.setitem(registry.MODEL_REGISTRY, "toy", toy)
    path = str(tmp_path / "toy.pv")
    tio.save_params(path, toy.init_params(), toy.DEFAULT_CONFIG)
    rng = np.random.default_rng(11)
    t = 12
    pcm = (rng.standard_normal((2, t * FRAME_LENGTH)) * 4000).astype(np.int16)
    half = np.round(pcm.astype(np.float64) * 0.5)

    out = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=2, model_path=path,
                                       device="cpu").enhance(pcm)
    assert out.shape == pcm.shape and np.abs(out - half).max() <= 1

    koala = koala_tpu_torch.create(ACCESS_KEY, model_path=path, device="cpu")
    frames = pcm[0].reshape(t, FRAME_LENGTH)
    got = np.stack([koala.process(f) for f in frames])
    assert np.abs(got[0]).max() <= 1                      # one hop of delay
    assert np.abs(got[1:] - half[0].reshape(t, FRAME_LENGTH)[:-1]).max() <= 1

    runner = CorpusRunner(path, 2, t * FRAME_LENGTH, mesh=make_mesh(["cpu"]))
    assert runner.engine.model is toy
    x = pcm.astype(np.float32) / 32768.0
    y = runner.enhance_batch(x).numpy().reshape(2, t, FRAME_LENGTH)
    np.testing.assert_allclose(y[:, 1:], 0.5 * x.reshape(2, t, FRAME_LENGTH)[:, :-1],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["use_pallas_false", "no_gate"])
def test_sequence_fast_without_the_fused_entry_is_sequence(case):
    """A mask_gru model that the fused entry does not take (its config turns
    the kernel branch off, or it has no passthrough gate) runs
    ``sequence_fast`` as ``sequence``, bit for bit, at a T the fused entry
    would take."""
    from koala_tpu_torch.ops.kernels import engine_fused

    cfg = dict(tmask.TRAIN_CONFIG, hidden=32, use_pallas=case == "no_gate")
    params = tmask.init_params(torch.Generator().manual_seed(4), cfg)
    if case == "no_gate":
        params.gate = None
    engine = make_engine("mask_gru", cfg)
    hops = torch.randn((3, 16, FRAME_LENGTH), generator=torch.Generator().manual_seed(2)) * 0.1
    assert engine_fused.fused_sequence_supported(cfg, 3, 16, hops.device)
    with torch.inference_mode():
        f_state, fast = engine.sequence_fast(params, engine.init_state((3,), "cpu"), hops)
        s_state, plain = engine.sequence(params, engine.init_state((3,), "cpu"), hops)
    assert torch.equal(fast, plain)
    for k, v in tio._flatten(s_state).items():
        assert np.array_equal(tio._flatten(f_state)[k], v), k
