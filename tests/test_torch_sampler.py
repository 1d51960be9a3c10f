"""Data side of the port's trainer: the numpy copies (data.py, corpus.py)
against the JAX package's, bit for bit, and the torch on-device sampler's
shapes, invariants and class shares."""

import numpy as np
import pytest
import torch

from koala_tpu.train import corpus as jcorpus
from koala_tpu.train import data as jdata
from koala_tpu_torch.constants import FRAME_LENGTH
from koala_tpu_torch.train import corpus as tcorpus
from koala_tpu_torch.train import data as tdata
from koala_tpu_torch.train import device_sampler as tds

import torch_ref  # noqa: F401  (thread count)


@pytest.fixture(scope="module")
def tapes():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 20000)
    speech = (np.sin(700 * np.pi * t) * (0.6 + 0.4 * np.sin(9 * np.pi * t)) * 0.3)
    noise = rng.standard_normal(20000) * 0.05
    return speech.astype(np.float32), noise.astype(np.float32)


def test_mixture_sampler_copy_is_bit_identical(tapes):
    speech, noise = tapes
    want = jdata.MixtureSampler([speech], [noise], segment_frames=10, seed=3)
    got = tdata.MixtureSampler([speech], [noise], segment_frames=10, seed=3)
    for _ in range(2):
        for a, b in zip(got.sample(16), want.sample(16)):
            np.testing.assert_array_equal(a, b)
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    for color in ("white", "pink", "brown"):
        np.testing.assert_array_equal(tdata.synth_noise(rng_a, 4000, color),
                                      jdata.synth_noise(rng_b, 4000, color))
    np.testing.assert_array_equal(tdata.speed_perturb(speech, 0.9),
                                  jdata.speed_perturb(speech, 0.9))


@pytest.mark.parametrize("tape", ["speech", "noise", "floor"])
def test_corpus_copy_is_bit_identical(tape):
    build = "build_%s_tape" % tape
    args = (7, 2) if tape == "speech" else (8, 7)
    np.testing.assert_array_equal(getattr(tcorpus, build)(*args),
                                  getattr(jcorpus, build)(*args))


def test_corpus_babble_copy_is_bit_identical():
    np.testing.assert_array_equal(tcorpus.synth_babble(np.random.default_rng(9), 0.5, 3),
                                  jcorpus.synth_babble(np.random.default_rng(9), 0.5, 3))


def _sample(tapes, seed, batch, frames=8, floor=False):
    speech, noise = tapes
    gen = torch.Generator().manual_seed(seed)
    ds = tds.DeviceSampler(speech, noise, frames * FRAME_LENGTH, device="cpu",
                           floor_tape=noise[::-1].copy() if floor else None)
    noisy, clean = ds.sample(gen, batch)
    return noisy.numpy(), clean.numpy()


@pytest.mark.parametrize("floor", [False, True])
def test_device_sampler_shapes_and_classes(tapes, floor):
    """The checks of tests/test_train.py's device-sampler test, plus the
    peak cap."""
    noisy, clean = _sample(tapes, 0, 32, floor=floor)
    assert noisy.shape == clean.shape == (32, 8 * FRAME_LENGTH)
    assert noisy.dtype == clean.dtype == np.float32
    assert np.isfinite(noisy).all() and np.isfinite(clean).all()
    same = [(noisy[i] == clean[i]).all() and np.abs(clean[i]).max() > 0 for i in range(32)]
    mixed = [not (noisy[i] == clean[i]).all() and np.abs(clean[i]).max() > 0
             for i in range(32)]
    assert any(same) and any(mixed)
    # every output is rescaled to a peak of at most 0.98 (one float32 ulp of slack)
    assert np.abs(noisy).max() <= 0.98 * (1 + 1e-6)


def test_device_sampler_same_seed_same_batch(tapes):
    a, b, c = _sample(tapes, 5, 16), _sample(tapes, 5, 16), _sample(tapes, 6, 16)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])


def test_device_sampler_class_shares(tapes):
    """Over 2048 draws the silence / speech-only / noise-only shares lie
    within 3 sigma of their probabilities. Classes are told apart as the
    sampler builds them: silence is all zero, speech-only has noisy == clean,
    a noise-only target is at most -24 dB of its input."""
    n = 2048
    noisy, clean = _sample(tapes, 11, n, frames=4)
    silent = np.abs(noisy).max(axis=1) == 0
    speech_only = (noisy == clean).all(axis=1) & ~silent
    e_noisy = (noisy.astype(np.float64) ** 2).sum(axis=1)
    e_clean = (clean.astype(np.float64) ** 2).sum(axis=1)
    noise_only = ~silent & ~speech_only & (e_clean <= e_noisy * 10 ** (-23.9 / 10))
    for flags, p in ((silent, tds.P_SILENCE), (speech_only, tds.P_SPEECH_ONLY),
                     (noise_only, tds.P_NOISE_ONLY)):
        sigma = np.sqrt(p * (1 - p) / n)
        assert abs(flags.mean() - p) <= 3 * sigma, (flags.mean(), p, sigma)


def test_device_sampler_refuses_short_tapes(tapes):
    speech, noise = tapes
    with pytest.raises(ValueError):
        tds.DeviceSampler(speech[:1000], noise, 8 * FRAME_LENGTH, device="cpu")


def test_device_sampler_asks_for_the_card_by_default(tapes, monkeypatch):
    """With no device the tapes go to the card, as koala_tpu's go to the
    default accelerator; without a card that is the typed error."""
    from koala_tpu_torch import KoalaInvalidArgumentError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    speech, noise = tapes
    with pytest.raises(KoalaInvalidArgumentError):
        tds.DeviceSampler(speech, noise, 8 * FRAME_LENGTH)
    assert tds.DeviceSampler(speech, noise, 8 * FRAME_LENGTH,
                             device=torch.device("cpu")).speech.device.type == "cpu"
