"""GRU stack of the port (ops/kernels/gru.py) against the JAX package's
Pallas kernel in interpret mode (koala_tpu/ops/pallas/gru.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from koala_tpu.models import mask_gru as jmask
import jax

from koala_tpu.ops.pallas.gru import (flatten_layer_params, gru_stack_pallas,
                                      gru_stack_trainable as jax_trainable)
from koala_tpu_torch.models.params_io import params_from_numpy
from koala_tpu_torch.ops.kernels import gru as tgru

from torch_ref import flat_tree, jax_params, rel_err

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


@pytest.mark.parametrize("layers", [1, 2])
def test_plain_return_hidden_matches_jax_kernel(layers):
    """The training variant: y, the streamed states hs and h_final against
    the Pallas kernel's return_hidden variant in interpret mode."""
    tree, x, h0 = _inputs(layers, 11 + layers)
    jy, jhs, jh = gru_stack_pallas(jnp.asarray(h0), jnp.asarray(x),
                                   *flatten_layer_params(tree["gru"]), interpret=True,
                                   return_hidden=True)
    wx, bx, wh, bh = params_from_numpy(tree, "cpu").gru_stacked()
    h0t, xt = torch.as_tensor(h0), torch.as_tensor(x).bfloat16()
    ty, ths, th = tgru.gru_stack(h0t, xt, wx, bx, wh, bh, return_hidden=True)
    assert ths.shape == (T, layers, B, H) and ths.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               atol=Y_ATOL, rtol=0)
    # hs is f32 state like h_final, at all T steps. Measured with these
    # seeds: max |dhs| = max |dh| = 1.3e-4 at L = 2 (7 elements of the last
    # step above 1e-4, after a flipped bf16 rounding of the layer input), so
    # both are held to twice the inference test's H_ATOL
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), atol=2 * H_ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2 * H_ATOL, rtol=0)
    # the two variants of the port agree bit for bit, and hs ends in h_final
    y0, hf0 = tgru.gru_stack(h0t, xt, wx, bx, wh, bh)
    assert torch.equal(ty, y0) and torch.equal(th, hf0) and torch.equal(ths[-1], th)


@pytest.mark.parametrize("layers", [1, 2])
def test_trainable_gradients_match_jax(layers):
    """Gradients of a seeded functional of (y, h_final) through the port's
    gru_stack_trainable (plain forward on the CPU, written-out reverse pass)
    against jax.grad through the JAX package's gru_stack_trainable in
    interpret mode."""
    tree, x, h0 = _inputs(layers, 21 + layers)
    rng = np.random.default_rng(99)
    cy = rng.standard_normal((T, B, H)).astype(np.float32)
    ch = rng.standard_normal((layers, B, H)).astype(np.float32)
    x_bf = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))

    def jfun(h0_, x_, gru_layers):
        y, hf = jax_trainable(h0_, x_, gru_layers, True)
        return jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(hf * ch)

    jg_h0, jg_x, jg_layers = jax.grad(jfun, argnums=(0, 1, 2))(
        jnp.asarray(h0), jnp.asarray(x_bf), [dict(l) for l in tree["gru"]])

    params = params_from_numpy(tree, "cpu").requires_grad_(True)
    h0t = torch.as_tensor(h0).requires_grad_(True)
    xt = torch.as_tensor(x_bf).requires_grad_(True)
    wx, bx, wh, bh = params.gru_stacked()
    y, hf = tgru.gru_stack_trainable(h0t, xt, wx, bx, wh, bh)
    assert y.dtype == torch.bfloat16
    ((y.float() * torch.as_tensor(cy)).sum() + (hf * torch.as_tensor(ch)).sum()).backward()

    # bf16 product operands round every cotangent that crosses them; the two
    # frameworks round at the same places but sum in another order, and the
    # port sums the weight gradients over T before any rounding. Measured:
    # <= 3e-3 relative on every leaf; the limit leaves a factor of three.
    tol = 1e-2
    assert xt.grad.dtype == torch.float32
    assert rel_err(np.asarray(jg_h0), h0t.grad.numpy()) < tol
    assert rel_err(np.asarray(jg_x), xt.grad.numpy()) < tol
    want = flat_tree({"gru": jg_layers})
    got = {n: p.grad.numpy() for n, p in params.named_parameters() if n.startswith("gru.")}
    assert set(want) == set(got)
    for name in want:
        assert rel_err(want[name], got[name]) < tol, name
    # nothing outside the stack took a gradient
    assert params.enc.w.grad is None and params.dec.w.grad is None
