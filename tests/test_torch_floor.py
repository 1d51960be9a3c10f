"""Floor tracker of the port (ops/kernels/floor.py) against the JAX
package's Pallas kernel in interpret mode: bit-identical, as
tests/test_pallas_floor.py holds the TPU kernel to its scan."""

import numpy as np
import torch

import jax.numpy as jnp

from koala_tpu.ops.pallas.floor import floor_scan_pallas
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
