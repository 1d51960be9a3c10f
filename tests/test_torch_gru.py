"""GRU stack of the port (ops/kernels/gru.py) against the JAX package's
Pallas kernel in interpret mode (koala_tpu/ops/pallas/gru.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from koala_tpu.models import mask_gru as jmask
from koala_tpu.ops.pallas.gru import flatten_layer_params, gru_stack_pallas
from koala_tpu_torch.models.params_io import params_from_numpy
from koala_tpu_torch.ops.kernels import gru as tgru

from torch_ref import jax_params

B, T, H = 8, 12, 384
# The plain version repeats the kernel's arithmetic (bf16 product operands,
# f32 sums, bf16 residual stream); only the summation order of the f32 sums
# differs (BLAS vs XLA), which can flip a bf16 rounding of the streamed x
# by one ulp (3.9e-3 at 0.5 <= |y| < 1). Measured here: max |dy| 2.0e-3
# (L=1) and 3.9e-3 (L=2), max |dh| 2.8e-5 and 8.3e-5. The tolerances are the
# tightest that pass, well inside tests/test_pallas_gru.py's atol 4e-2.
Y_ATOL, H_ATOL = 4e-3, 1e-4


def _inputs(layers, seed):
    cfg = dict(jmask.DEFAULT_CONFIG, num_layers=layers)
    tree = jax_params(cfg, seed)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, B, H)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((layers, B, H)) * 0.2).astype(np.float32)
    return tree, x, h0


@pytest.mark.parametrize("layers", [1, 2])
def test_plain_matches_jax_kernel(layers):
    tree, x, h0 = _inputs(layers, 3 + layers)
    jy, jh = gru_stack_pallas(jnp.asarray(h0), jnp.asarray(x),
                              *flatten_layer_params(tree["gru"]), interpret=True)
    jy = np.asarray(jy.astype(jnp.float32))
    params = params_from_numpy(tree, "cpu")
    wx, bx, wh, bh = params.gru_stacked()
    ty, th = tgru.gru_stack(torch.as_tensor(h0), torch.as_tensor(x).bfloat16(), wx, bx, wh, bh)
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    ty = ty.float().numpy()
    np.testing.assert_allclose(ty, jy, atol=Y_ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=H_ATOL, rtol=0)
    assert np.corrcoef(ty.ravel(), jy.ravel())[0, 1] > 0.99999


def test_chunked_equals_continuous():
    tree, x, h0 = _inputs(2, 7)
    wx, bx, wh, bh = params_from_numpy(tree, "cpu").gru_stacked()
    xt, h0t = torch.as_tensor(x).bfloat16(), torch.as_tensor(h0)
    y, hf = tgru.gru_stack(h0t, xt, wx, bx, wh, bh)
    y1, h1 = tgru.gru_stack(h0t, xt[:5], wx, bx, wh, bh)
    y2, h2 = tgru.gru_stack(h1, xt[5:], wx, bx, wh, bh)
    assert torch.equal(torch.cat([y1, y2]), y) and torch.equal(h2, hf)
