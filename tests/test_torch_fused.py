"""Fused engine of the port (ops/kernels/engine_fused.py) against the JAX
package's fused Pallas kernel in interpret mode, with TRAIN_CONFIG, B=8,
T=24 (as tests/test_fused_engine.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koala_tpu.engine.core import make_engine as jmake_engine
from koala_tpu.models import mask_gru as jmask
from koala_tpu.ops.pallas.engine_fused import fused_sequence as jfused
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models.params_io import params_from_numpy, state_from_numpy
from koala_tpu_torch.ops.kernels import engine_fused as tfused

from torch_ref import jax_params, snr_db

CFG = dict(jmask.TRAIN_CONFIG)
B, T = 8, 24


@pytest.fixture(scope="module")
def setup():
    tree = jax_params(CFG, 3)
    rng = np.random.default_rng(4)
    hops = (0.05 * rng.standard_normal((B, T, 256))).astype(np.float32)
    return tree, hops


def test_supported_gate():
    """The configuration conditions; the shared-memory one is asked of the
    CUDA library and tested on the card (tests/test_torch_cuda.py)."""
    cpu = torch.device("cpu")
    assert tfused.fused_sequence_supported(CFG, 64, 376, cpu)
    assert tfused.fused_sequence_supported(CFG, 1, 8, cpu)
    assert tfused.fused_sequence_supported(CFG, 9, 13, cpu)          # any B, any T
    assert tfused.fused_sequence_supported(dict(CFG, num_layers=12), 64, 376, cpu)
    assert not tfused.fused_sequence_supported(dict(CFG, snr_bands=0), 64, 376, cpu)
    assert not tfused.fused_sequence_supported(dict(CFG, compute_dtype="float32"), 64,
                                               376, cpu)
    assert not tfused.fused_sequence_supported(dict(CFG, hidden=200), 64, 376, cpu)


def test_plain_matches_jax_kernel(setup):
    """Same arithmetic on the same operands; only f32 summation order (BLAS
    vs XLA, and zero padding 272 vs 384 lanes) differs, which can flip a bf16
    rounding. Measured here: 75.1 dB, max |out err| 5.6e-5 (|out| <= 0.19);
    state: max |dh| 5.5e-4, |dfloor| 2.3e-3, |dola| 5.3e-5. A flipped bf16
    rounding of one band power moves its log by up to 2**-8 = 3.9e-3, which
    bounds the floor's tolerance."""
    tree, hops = setup
    jstate = jmake_engine("mask_gru", CFG).init_state((B,))
    jst, jout = jfused(jax.tree_util.tree_map(jnp.asarray, tree), jstate,
                       jnp.asarray(hops), CFG, interpret=True, b_tile=B)
    params = params_from_numpy(tree, "cpu")
    state = make_engine("mask_gru", CFG).init_state((B,), "cpu")
    st, out = tfused.fused_sequence_ref(params, state, torch.as_tensor(hops), CFG)
    jout = np.asarray(jout)
    assert snr_db(jout, out.numpy()) >= 60.0
    assert np.max(np.abs(out.numpy() - jout)) < 1e-4
    np.testing.assert_allclose(st["model"]["h"].numpy(), np.asarray(jst["model"]["h"]),
                               atol=1e-3)
    np.testing.assert_allclose(st["model"]["floor"].numpy(),
                               np.asarray(jst["model"]["floor"]), atol=4e-3)
    np.testing.assert_allclose(st["ola"].numpy(), np.asarray(jst["ola"]), atol=1e-4)
    np.testing.assert_array_equal(st["input_carry"].numpy(), np.asarray(jst["input_carry"]))


def test_chunked_equals_continuous(setup):
    tree, hops = setup
    params = params_from_numpy(tree, "cpu")
    state = make_engine("mask_gru", CFG).init_state((B,), "cpu")
    h = torch.as_tensor(hops)
    _, full = tfused.fused_sequence(params, state, h, CFG)
    st, a = tfused.fused_sequence(params, state, h[:, :8], CFG)
    _, b = tfused.fused_sequence(params, st, h[:, 8:], CFG)
    assert torch.equal(torch.cat([a, b], dim=1), full)


def test_close_to_own_engine(setup):
    """bf16 spectral rounding only: the mirror tracks the port's own f32
    sequence engine within 35 dB (tests/test_fused_engine.py's bound)."""
    tree, hops = setup
    params = params_from_numpy(tree, "cpu")
    engine = make_engine("mask_gru", CFG)
    state = engine.init_state((B,), "cpu")
    _, ref = tfused.fused_sequence_ref(params, state, torch.as_tensor(hops), CFG)
    _, xla = engine.sequence(params, state, torch.as_tensor(hops))
    assert snr_db(xla.numpy(), ref.numpy()) > 35.0


def test_sequence_fast_splits_at_multiple_of_8(setup):
    """With the kernel branch forced on the CPU, sequence_fast runs the fused
    plain version over 16 hops and the 5-hop tail through sequence."""
    tree, hops = setup
    cfg = dict(CFG, use_pallas=True)
    params = params_from_numpy(tree, "cpu")
    engine = make_engine("mask_gru", cfg)
    state = engine.init_state((B,), "cpu")
    h = torch.as_tensor(hops[:, :21])
    st, out = engine.sequence_fast(params, state, h)
    st16, head = tfused.fused_sequence_ref(params, state, h[:, :16], cfg)
    _, tail = engine.sequence(params, st16, h[:, 16:])
    assert torch.equal(out, torch.cat([head, tail], dim=1))
    auto = make_engine("mask_gru", CFG)       # "auto" on the CPU: plain sequence
    _, out_auto = auto.sequence_fast(params, state, h)
    assert torch.equal(out_auto, auto.sequence(params, state, h)[1])
