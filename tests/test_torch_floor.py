"""Floor tracker of the port (ops/kernels/floor.py) against the JAX
package's Pallas kernel in interpret mode: bit-identical, as
tests/test_pallas_floor.py holds the TPU kernel to its scan."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from koala_tpu.ops.pallas.floor import floor_scan_pallas
from koala_tpu.ops.pallas.floor import floor_scan_trainable as jax_trainable
from koala_tpu_torch.ops.kernels import floor as tfloor

import torch_ref  # noqa: F401  (thread count)

RISE = 0.012


def _inputs(seed, t=23, b=16, nb=32):
    rng = np.random.default_rng(seed)
    lb = (rng.standard_normal((t, b, nb)) * 3.0).astype(np.float32)
    floor0 = np.full((b, nb), 30.0, np.float32)
    floor0[::3] = (rng.standard_normal((len(floor0[::3]), nb)) * 2.0).astype(np.float32)
    return floor0, lb


def test_plain_bit_identical_to_jax_kernel():
    floor0, lb = _inputs(0)
    jf, jfl = floor_scan_pallas(jnp.asarray(floor0), jnp.asarray(lb), RISE, interpret=True)
    tf, tfl = tfloor.floor_scan_ref(torch.as_tensor(floor0), torch.as_tensor(lb), RISE)
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_wrapper_takes_plain_version_on_cpu():
    floor0, lb = _inputs(1, t=9, b=5)
    before = tfloor.launches
    a = tfloor.floor_scan(torch.as_tensor(floor0), torch.as_tensor(lb), RISE)
    b = tfloor.floor_scan_ref(torch.as_tensor(floor0), torch.as_tensor(lb), RISE)
    assert tfloor.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_chunked_equals_continuous():
    floor0, lb = _inputs(2, t=20)
    f0, lbt = torch.as_tensor(floor0), torch.as_tensor(lb)
    _, full = tfloor.floor_scan(f0, lbt, RISE)
    mid, a = tfloor.floor_scan(f0, lbt[:11], RISE)
    _, b = tfloor.floor_scan(mid, lbt[11:], RISE)
    assert torch.equal(torch.cat([a, b]), full)


def _grads_both(floor0, lb, seed):
    """(JAX, port) gradients of a seeded functional of (floor_final, floors)."""
    rng = np.random.default_rng(seed)
    cf = rng.standard_normal(floor0.shape).astype(np.float32)
    cfl = rng.standard_normal(lb.shape).astype(np.float32)

    def jfun(f0, x):
        ff, fl = jax_trainable(f0, x, RISE, True)
        return jnp.sum(ff * cf) + jnp.sum(fl * cfl)

    jg = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(floor0), jnp.asarray(lb))
    f0 = torch.as_tensor(floor0).requires_grad_(True)
    lbt = torch.as_tensor(lb).requires_grad_(True)
    ff, fl = tfloor.floor_scan_trainable(f0, lbt, RISE)
    ((ff * torch.as_tensor(cf)).sum() + (fl * torch.as_tensor(cfl)).sum()).backward()
    return jg, (f0.grad.numpy(), lbt.grad.numpy()), (ff, fl)


def test_trainable_gradients_match_jax():
    """The recurrence is piecewise linear and both backward passes add the
    same terms in the same order: equal to the last bit (atol 1e-6 allows
    for a fused multiply-add on one side)."""
    floor0, lb = _inputs(3)
    jg, tg, (ff, fl) = _grads_both(floor0, lb, 5)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg[1], np.asarray(jg[1]), atol=1e-6, rtol=0)
    # the forward of the differentiable form stays bit-identical
    rf, rfl = tfloor.floor_scan_ref(torch.as_tensor(floor0), torch.as_tensor(lb), RISE)
    assert torch.equal(ff.detach(), rf) and torch.equal(fl.detach(), rfl)


def _tie_inputs():
    """lb[1] equals floor[0] + rise exactly (computed in float32) in half of
    the columns: the min's two arguments tie there."""
    floor0, lb = _inputs(4, t=6, b=4)
    f1 = np.minimum(floor0 + np.float32(RISE), lb[0])
    lb[1, :, ::2] = (f1 + np.float32(RISE))[:, ::2]
    return floor0, lb


def test_trainable_tie_goes_to_the_rise_branch():
    """At an exact tie the analytic backward gives the whole gradient to the
    first argument (floor + rise), in both packages."""
    floor0, lb = _tie_inputs()
    jg, tg, _ = _grads_both(floor0, lb, 6)
    np.testing.assert_allclose(tg[0], np.asarray(jg[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg[1], np.asarray(jg[1]), atol=1e-6, rtol=0)
    assert np.all(tg[1][1, :, ::2] == 0.0)      # nothing reaches lb at the tie
    assert np.any(tg[1][1, :, 1::2] != 0.0)


def test_scan_branch_tie_halves_like_the_jax_scan():
    """The plain scan is ordinary autograd: torch.minimum splits a tie half
    and half, as jnp.minimum does in the JAX scan branch."""
    floor0, lb = _tie_inputs()
    rng = np.random.default_rng(7)
    cfl = rng.standard_normal(lb.shape).astype(np.float32)

    def jfun(f0, x):
        def body(fl, xt):
            fl2 = jnp.minimum(fl + RISE, xt)
            return fl2, fl2
        return jnp.sum(jax.lax.scan(body, f0, x)[1] * cfl)

    jg = jax.grad(jfun, argnums=(0, 1))(jnp.asarray(floor0), jnp.asarray(lb))
    f0 = torch.as_tensor(floor0).requires_grad_(True)
    lbt = torch.as_tensor(lb).requires_grad_(True)
    _, fl = tfloor.floor_scan_ref(f0, lbt, RISE)
    (fl * torch.as_tensor(cfl)).sum().backward()
    np.testing.assert_allclose(f0.grad.numpy(), np.asarray(jg[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lbt.grad.numpy(), np.asarray(jg[1]), atol=1e-6, rtol=0)
    assert np.any(lbt.grad.numpy()[1, :, ::2] != 0.0)   # the tie's half share
