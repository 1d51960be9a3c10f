"""ops/stft.py of the port against koala_tpu.ops.stft (float32 on the CPU)."""

import numpy as np
import torch

import jax.numpy as jnp

from koala_tpu.ops import stft as jstft
from koala_tpu_torch.constants import FFT_SIZE, FRAME_LENGTH
from koala_tpu_torch.ops import stft as tstft

import torch_ref  # noqa: F401  (thread count)

# Both packages build the bases in float64 numpy and run f32 matmuls; only
# the summation order of the two BLAS libraries differs (~1e-6 at |x| ~ 10).
ATOL = 1e-5


def test_bases_identical():
    for a, b in zip(jstft._windowed_bases(FFT_SIZE), tstft._windowed_bases(FFT_SIZE)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jstft._numpy_basis(FFT_SIZE), tstft._numpy_basis(FFT_SIZE)):
        np.testing.assert_array_equal(a, b)


def test_stft_istft_match_jax():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 5, FFT_SIZE)) * 0.3).astype(np.float32)
    for windowed in (True, False):
        jre, jim = jstft.stft_frame(jnp.asarray(x), windowed=windowed)
        tre, tim = tstft.stft_frame(torch.as_tensor(x), windowed=windowed)
        np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=ATOL)
        np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=ATOL)
        jy = jstft.istft_frame(jre, jim, windowed=windowed)
        ty = tstft.istft_frame(tre, tim, windowed=windowed)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


def test_frame_signal_and_overlap_add_match_jax():
    rng = np.random.default_rng(12)
    pcm = rng.standard_normal((2, 7 * FRAME_LENGTH)).astype(np.float32)
    tf = tstft.frame_signal(torch.as_tensor(pcm))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jstft.frame_signal(jnp.asarray(pcm))))
    np.testing.assert_array_equal(
        tstft.overlap_add(tf).numpy(), np.asarray(jstft.overlap_add(jnp.asarray(tf.numpy()))))


def test_perfect_reconstruction_through_unit_mask():
    """Analysis -> unit mask -> synthesis reproduces the input delayed by one
    hop (the engine's delay_sample contract)."""
    rng = np.random.default_rng(13)
    t = 12
    x = rng.standard_normal((2, t * FRAME_LENGTH)).astype(np.float32)
    re, im = tstft.stft_frame(tstft.frame_signal(torch.as_tensor(x)))
    mask = torch.ones_like(re)
    y = tstft.overlap_add(tstft.istft_frame(re * mask, im * mask)).numpy()
    assert y.shape == x.shape
    np.testing.assert_allclose(y[:, FRAME_LENGTH:], x[:, :(t - 1) * FRAME_LENGTH], atol=1e-4)
    w = tstft.analysis_window().numpy()
    np.testing.assert_allclose(w[:FRAME_LENGTH] ** 2 + w[FRAME_LENGTH:] ** 2, 1.0, atol=1e-6)


def test_dft_matrices_match_jax():
    """``dft_matrices`` is exported from ``ops`` as in koala_tpu, with the
    same four unwindowed bases, bit for bit."""
    from koala_tpu.ops import dft_matrices as jdft
    from koala_tpu_torch.ops import dft_matrices

    for fft_size in (FFT_SIZE, 64):
        mine, theirs = dft_matrices(fft_size), jdft(fft_size)
        assert len(mine) == len(theirs) == 4
        for a, b in zip(mine, theirs):
            assert a.dtype == torch.float32 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
