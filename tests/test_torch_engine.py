"""Engine core of the port (engine/core.py, engine/batch.py): its own
contracts, and agreement with koala_tpu's engine on the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koala_tpu.engine.core import make_engine as jmake_engine
from koala_tpu.models import mask_gru as jmask
from koala_tpu_torch.constants import DELAY_SAMPLE, FRAME_LENGTH
from koala_tpu_torch.engine.batch import masked_reset
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models import identity
from koala_tpu_torch.models.params_io import params_from_numpy

from torch_ref import jax_params, to_numpy

SETUPS = {
    "identity": ("identity", identity.DEFAULT_CONFIG),
    "mask_gru": ("mask_gru", jmask.DEFAULT_CONFIG),
    "mask_gru_train": ("mask_gru", jmask.TRAIN_CONFIG),
}


def _setup(name):
    kind, cfg = SETUPS[name]
    if kind == "identity":
        tree = {"empty": np.zeros((1,), np.float32)}
    else:
        tree = jax_params(cfg, 0)
    return kind, cfg, tree, make_engine(kind, cfg), params_from_numpy(tree, "cpu", kind)


def _hops(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("name", list(SETUPS))
def test_step_fold_equals_sequence(name):
    """tests/test_engine.py:28-53's tolerances: outputs atol 1e-5, state
    rtol 1e-4 / atol 3e-5."""
    _, _, _, engine, params = _setup(name)
    b, t = 3, 6
    hops = _hops(0, (b, t, FRAME_LENGTH))
    state = engine.init_state((b,), "cpu")
    outs = []
    for i in range(t):
        state, out = engine.step(params, state, hops[:, i])
        outs.append(out)
    state2, seq = engine.sequence(params, engine.init_state((b,), "cpu"), hops)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), seq.numpy(), atol=1e-5)
    a, c = to_numpy(state), to_numpy(state2)
    for k in ("input_carry", "ola"):
        np.testing.assert_allclose(a[k], c[k], rtol=1e-4, atol=3e-5)
    ma, mc = a["model"], c["model"]
    for x, y in ([(ma[k], mc[k]) for k in ma] if isinstance(ma, dict) else [(ma, mc)]):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=3e-5)


@pytest.mark.parametrize("name", ["mask_gru", "mask_gru_train"])
def test_sequence_matches_jax_engine(name):
    """The port's sequence engine against koala_tpu's on the same weights:
    audio within 1e-5 (tests/test_engine.py's cross-path output bound)."""
    kind, cfg, tree, engine, params = _setup(name)
    hops = _hops(1, (2, 12, FRAME_LENGTH))
    jengine = jmake_engine(kind, cfg)
    _, jout = jengine.sequence(jax.tree_util.tree_map(jnp.asarray, tree),
                               jengine.init_state((2,)), jnp.asarray(hops.numpy()))
    _, out = engine.sequence(params, engine.init_state((2,), "cpu"), hops)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)


def test_identity_engine_is_pure_delay():
    _, _, _, engine, params = _setup("identity")
    t = 10
    x = _hops(2, (t * FRAME_LENGTH,), 0.5)
    _, out = engine.sequence(params, engine.init_state((), "cpu"), x.reshape(t, FRAME_LENGTH))
    y = out.reshape(-1).numpy()
    np.testing.assert_allclose(y[DELAY_SAMPLE:], x.numpy()[:-DELAY_SAMPLE], atol=1e-4)
    np.testing.assert_allclose(y[:DELAY_SAMPLE], 0.0, atol=1e-4)


@pytest.mark.parametrize("name", list(SETUPS))
def test_sequence_chunking_equivalence(name):
    _, _, _, engine, params = _setup(name)
    hops = _hops(3, (2, 12, FRAME_LENGTH))
    _, full = engine.sequence(params, engine.init_state((2,), "cpu"), hops)
    st, a = engine.sequence(params, engine.init_state((2,), "cpu"), hops[:, :5])
    _, b = engine.sequence(params, st, hops[:, 5:])
    assert torch.equal(torch.cat([a, b], 1), full)


@pytest.mark.parametrize("name", list(SETUPS))
def test_masked_reset_matches_fresh_stream(name):
    _, _, _, engine, params = _setup(name)
    b = 4
    hops_a, hops_b = _hops(4, (b, 5, FRAME_LENGTH)), _hops(5, (b, 5, FRAME_LENGTH))
    state, _ = engine.sequence(params, engine.init_state((b,), "cpu"), hops_a)
    state = masked_reset(state, engine.init_state((b,), "cpu"),
                         torch.tensor([True, False, False, False]))
    _, out = engine.sequence(params, state, hops_b)
    _, fresh = engine.sequence(params, engine.init_state((b,), "cpu"), hops_b)
    assert torch.equal(out[0], fresh[0])
    cont, _ = engine.sequence(params, engine.init_state((b,), "cpu"), hops_a)
    _, cont_out = engine.sequence(params, cont, hops_b)
    assert torch.equal(out[1], cont_out[1])


@pytest.mark.parametrize("name", list(SETUPS))
def test_rerun_determinism(name):
    _, _, _, engine, params = _setup(name)
    hops = _hops(6, (2, 8, FRAME_LENGTH))
    _, a = engine.sequence(params, engine.init_state((2,), "cpu"), hops)
    _, b = engine.sequence(params, engine.init_state((2,), "cpu"), hops)
    assert torch.equal(a, b)


def test_chunk_masked_equals_masked_steps():
    _, _, _, engine, params = _setup("mask_gru_train")
    b, k = 3, 4
    hops = _hops(7, (b, k, FRAME_LENGTH))
    counts = torch.tensor([4, 0, 2])
    st_c, out_c = engine.chunk_masked(params, engine.init_state((b,), "cpu"), hops, counts)
    st = engine.init_state((b,), "cpu")
    outs = []
    for j in range(k):
        st, o = engine.step_masked(params, st, hops[:, j], j < counts)
        outs.append(o)
    assert torch.equal(out_c, torch.stack(outs, 1))
    for x, y in zip(to_numpy(st_c)["model"].values(), to_numpy(st)["model"].values()):
        np.testing.assert_array_equal(x, y)
    fresh = to_numpy(engine.init_state((b,), "cpu"))
    np.testing.assert_array_equal(to_numpy(st_c)["ola"][1], fresh["ola"][1])


# ---- one stream on the kernel branch: the recurrences get a batch axis

def _bundled_kernel_branch():
    """The bundled model with the kernel branch forced (on the CPU: the
    kernels' plain versions, the branch a card takes)."""
    from koala_tpu_torch.engine.core import Engine
    from koala_tpu_torch.engine.stream import load_model
    from koala_tpu_torch.models.params_io import default_model_path

    engine, params = load_model(default_model_path(), "cpu")
    return Engine(engine.kind, dict(engine.config, use_pallas=True)), params


class _Spy:
    """Counts the calls of ``module.name`` and passes them on."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        orig = getattr(module, name)

        def wrapped(*args, **kwargs):
            self.calls += 1
            return orig(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)


def _forbid(monkeypatch, module, name):
    def refuse(*args, **kwargs):
        raise AssertionError("%s was called on the kernel branch" % name)
    monkeypatch.setattr(module, name, refuse)


def test_unbatched_sequence_reaches_the_kernel_wrappers(monkeypatch):
    """An unbatched [T, 256] ``sequence`` (one stream's ``Koala.enhance``) on
    the kernel branch calls the floor and GRU wrappers once each, and never
    the floor's plain scan or the GRU step loop."""
    from koala_tpu_torch.models import mask_gru as tmask

    engine, params = _bundled_kernel_branch()
    floor = _Spy(monkeypatch, tmask, "floor_scan")
    gru = _Spy(monkeypatch, tmask, "gru_stack")
    _forbid(monkeypatch, tmask, "floor_scan_ref")
    _forbid(monkeypatch, tmask, "_gru_recurrent")
    state, out = engine.sequence(params, engine.init_state((), "cpu"),
                                 _hops(11, (9, FRAME_LENGTH), 0.05))
    assert (floor.calls, gru.calls) == (1, 1)
    assert out.shape == (9, FRAME_LENGTH)
    assert state["model"]["h"].shape == (2, 384) and state["model"]["floor"].shape == (32,)


@pytest.mark.parametrize("t_len", [1, 2, 9, 376])
def test_unbatched_kernel_branch_equals_batch_of_one(t_len):
    """Output and state of an unbatched call equal those of the same hops as
    a batch of one, squeezed, bit for bit."""
    engine, params = _bundled_kernel_branch()
    hops = _hops(12 + t_len, (t_len, FRAME_LENGTH), 0.05)
    state, out = engine.sequence(params, engine.init_state((), "cpu"), hops)
    state1, out1 = engine.sequence(params, engine.init_state((1,), "cpu"), hops[None])
    assert torch.equal(out, out1[0])
    for key in ("input_carry", "ola"):
        assert torch.equal(state[key], state1[key][0]), key
    for key in ("h", "floor"):
        assert torch.equal(state["model"][key], state1["model"][key][0]), key


def test_two_batch_axes_on_the_kernel_branch_equal_one():
    """A batch of two axes [2, 3, T, 256] is flattened to one for the
    recurrences: the same bits as [6, T, 256], reshaped."""
    engine, params = _bundled_kernel_branch()
    hops = _hops(13, (2, 3, 5, FRAME_LENGTH), 0.05)
    state, out = engine.sequence(params, engine.init_state((2, 3), "cpu"), hops)
    state6, out6 = engine.sequence(params, engine.init_state((6,), "cpu"),
                                   hops.reshape(6, 5, FRAME_LENGTH))
    assert torch.equal(out, out6.reshape(out.shape))
    for key in ("h", "floor"):
        assert torch.equal(state["model"][key],
                           state6["model"][key].reshape(state["model"][key].shape)), key


def test_unbatched_model_without_a_plan_takes_the_scan_with_one_warning(monkeypatch, caplog):
    """Hidden 768 x 3 has no GRU launch plan: an unbatched call on the kernel
    branch runs the floor wrapper and the GRU step loop, and warns once over
    two calls."""
    from koala_tpu_torch.models import mask_gru as tmask

    cfg = dict(tmask.TRAIN_CONFIG, hidden=768, num_layers=3, use_pallas=True)
    params = tmask.init_params(torch.Generator().manual_seed(5), cfg)
    engine = make_engine("mask_gru", cfg)
    monkeypatch.setattr(tmask, "_FALLBACK_WARNED", set())
    floor = _Spy(monkeypatch, tmask, "floor_scan")
    gru = _Spy(monkeypatch, tmask, "gru_stack")
    steps = _Spy(monkeypatch, tmask, "_gru_recurrent")
    hops = _hops(14, (4, FRAME_LENGTH), 0.05)
    with caplog.at_level("WARNING", logger="koala_tpu_torch"):
        for _ in range(2):
            _, out = engine.sequence(params, engine.init_state((), "cpu"), hops)
    warned = [r for r in caplog.records if "GRU kernel DISABLED" in r.getMessage()]
    assert len(warned) == 1
    assert (floor.calls, gru.calls, steps.calls) == (2, 0, 2 * 4 * 3)
    assert out.shape == (4, FRAME_LENGTH) and torch.isfinite(out).all()
