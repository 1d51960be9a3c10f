"""Public surface of the port on the bundled model, device="cpu", against
koala_tpu on the CPU: within 2 int16 LSB (tests/test_serve.py's cross-
program tolerance), plus the error contract of tests/test_api.py."""

import os

import numpy as np
import pytest

import koala_tpu
import koala_tpu_torch
from koala_tpu_torch import (
    KoalaActivationError,
    KoalaActivationRefusedError,
    KoalaError,
    KoalaInvalidArgumentError,
    KoalaInvalidStateError,
    KoalaIOError,
)
from koala_tpu_torch.constants import FRAME_LENGTH
from koala_tpu_torch.io import read_wav

from torch_ref import ACCESS_KEY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(ROOT, "resources", "audio_samples")
LSB = 2
FRAMES = 120      # per-frame process() comparison length (1.9 s)


@pytest.fixture(scope="module")
def mix():
    speech = read_wav(os.path.join(AUDIO, "speech_synth.wav")).astype(np.int32)
    noise = read_wav(os.path.join(AUDIO, "noise_synth.wav")).astype(np.int32)
    n = min(len(speech), len(noise))
    return np.clip(speech[:n] + noise[:n], -32768, 32767).astype(np.int16)


def _lsb(a, b):
    return int(np.max(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))))


def test_process_matches_jax(mix):
    pcm = mix[:FRAMES * FRAME_LENGTH]
    t = koala_tpu_torch.create(ACCESS_KEY, device="cpu")
    j = koala_tpu.create(ACCESS_KEY, device="cpu")
    for s in range(0, len(pcm), FRAME_LENGTH):
        frame = pcm[s:s + FRAME_LENGTH].tolist()
        a, b = t.process(frame), j.process(frame)
        assert len(a) == FRAME_LENGTH and all(isinstance(v, int) for v in a)
        assert _lsb(a, b) <= LSB, s
    t.delete()
    j.delete()


def test_enhance_matches_jax(mix):
    t = koala_tpu_torch.create(ACCESS_KEY, device="cpu")
    j = koala_tpu.create(ACCESS_KEY, device="cpu")
    a, b = t.enhance(mix), j.enhance(mix)
    assert a.shape == mix.shape and a.dtype == np.int16
    assert _lsb(a, b) <= LSB
    t.delete()
    j.delete()


def test_batch_surface_matches_jax(mix):
    n = 60 * FRAME_LENGTH
    pcm = np.stack([mix[:n], mix[n:2 * n]])
    t = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=2, device="cpu")
    j = koala_tpu.create_batch(ACCESS_KEY, batch_size=2, device="cpu")
    assert _lsb(t.process_chunk(pcm), j.process_chunk(pcm)) <= LSB
    assert _lsb(t.process_chunk(pcm[:, ::-1].copy()),
                j.process_chunk(pcm[:, ::-1].copy())) <= LSB     # carried state
    t.reset()
    j.reset()
    a, b = t.enhance(pcm[:, :5000]), j.enhance(pcm[:, :5000])
    assert a.shape == (2, 5000)
    assert _lsb(a, b) <= LSB
    t.delete()
    j.delete()


def test_snapshot_loads_across_packages(mix):
    """A snapshot from either package resumes the stream in the other."""
    pcm = mix[:16 * FRAME_LENGTH]
    half = 8 * FRAME_LENGTH
    j = koala_tpu.create(ACCESS_KEY, device="cpu")
    full = np.concatenate([j.process(pcm[s:s + FRAME_LENGTH].tolist())
                           for s in range(0, len(pcm), FRAME_LENGTH)])
    j.reset()
    for s in range(0, half, FRAME_LENGTH):
        j.process(pcm[s:s + FRAME_LENGTH].tolist())
    t = koala_tpu_torch.create(ACCESS_KEY, device="cpu")
    t.load_state(j.save_state())
    second = np.concatenate([t.process(pcm[s:s + FRAME_LENGTH].tolist())
                             for s in range(half, len(pcm), FRAME_LENGTH)])
    assert _lsb(second, full[half:]) <= LSB
    j2 = koala_tpu.create(ACCESS_KEY, device="cpu")
    j2.load_state(t.save_state())
    assert set(t.save_state()) == set(j.save_state())
    t.delete()
    j.delete()
    j2.delete()


def test_reset_and_snapshot_are_exact(mix):
    pcm = mix[:10 * FRAME_LENGTH]
    t = koala_tpu_torch.create(ACCESS_KEY, device="cpu")
    first = [t.process(pcm[s:s + FRAME_LENGTH].tolist()) for s in range(0, len(pcm), 256)]
    t.reset()
    again = [t.process(pcm[s:s + FRAME_LENGTH].tolist()) for s in range(0, len(pcm), 256)]
    assert first == again
    t.reset()
    head = [t.process(pcm[s:s + FRAME_LENGTH].tolist()) for s in range(0, 1280, 256)]
    snap = t.save_state()
    t2 = koala_tpu_torch.create(ACCESS_KEY, device="cpu")
    t2.load_state(snap)
    tail = [t2.process(pcm[s:s + FRAME_LENGTH].tolist()) for s in range(1280, len(pcm), 256)]
    assert head + tail == first
    bad = dict(snap)
    bad.pop(sorted(bad)[0])
    with pytest.raises(KoalaInvalidArgumentError):
        t2.load_state(bad)


def test_batch_per_stream_reset(mix):
    n = 5 * FRAME_LENGTH
    pcm = np.stack([mix[:n], mix[n:2 * n]])
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=2, device="cpu")
    kb.process_chunk(pcm)
    kb.reset([0])
    second = kb.process_chunk(pcm)
    kb.reset()
    fresh = kb.process_chunk(pcm)
    np.testing.assert_array_equal(second[0], fresh[0])
    assert not np.array_equal(second[1], fresh[1])
    with pytest.raises(KoalaInvalidArgumentError):
        kb.reset([2])
    with pytest.raises(KoalaInvalidArgumentError):
        kb.process(np.zeros((3, FRAME_LENGTH), np.int16))
    with pytest.raises(KoalaInvalidArgumentError):
        kb.process_chunk(np.zeros((2, FRAME_LENGTH + 1), np.int16))
    assert kb.process(np.zeros((2, FRAME_LENGTH), np.int16)).shape == (2, FRAME_LENGTH)
    kb.delete()
    with pytest.raises(KoalaInvalidStateError):
        kb.process_chunk(pcm)


def test_properties_and_errors(tmp_path):
    k = koala_tpu_torch.create(ACCESS_KEY, device="cpu")
    assert (k.sample_rate, k.frame_length, k.delay_sample) == (16000, 256, 256)
    assert isinstance(k.version, str) and k.version
    with pytest.raises(KoalaInvalidArgumentError):
        k.process([0] * (FRAME_LENGTH - 1))
    handle = k._handle
    k._handle = None
    with pytest.raises(KoalaError) as e:
        k.process([0] * FRAME_LENGTH)
    assert 0 < len(e.value.message_stack) < 8
    k._handle = handle
    k.delete()
    with pytest.raises(KoalaInvalidStateError):
        k.process([0] * FRAME_LENGTH)
    stacks = []
    for _ in range(2):
        with pytest.raises(KoalaActivationError) as e:
            koala_tpu_torch.create("invalid", device="cpu")
        stacks.append(list(e.value.message_stack))
    assert stacks[0] == stacks[1] and 0 < len(stacks[0]) < 8
    with pytest.raises(KoalaInvalidArgumentError):
        koala_tpu_torch.create("", device="cpu")
    with pytest.raises(KoalaError):
        koala_tpu_torch.create(ACCESS_KEY, model_path="/nonexistent/model.pv", device="cpu")
    with pytest.raises(KoalaInvalidArgumentError):
        koala_tpu_torch.create(ACCESS_KEY, device="quantum:0")
    with pytest.raises(KoalaInvalidArgumentError):
        koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=0, device="cpu")
    broken = tmp_path / "broken.pv"
    broken.write_bytes(b"not a model")
    with pytest.raises(KoalaIOError):
        koala_tpu_torch.create(ACCESS_KEY, model_path=str(broken), device="cpu")


def test_sdk_and_revoked_key(monkeypatch):
    assert koala_tpu_torch.get_sdk() == "python"
    koala_tpu_torch.set_sdk("unit-test")
    try:
        assert koala_tpu_torch.get_sdk() == "unit-test"
    finally:
        koala_tpu_torch.set_sdk("python")
    key = "REVOKED0" * 2
    monkeypatch.setenv("KOALA_TPU_REVOKED_KEYS", "otherkey, %s" % key)
    with pytest.raises(KoalaActivationRefusedError) as e:
        koala_tpu_torch.create(key, device="cpu")
    assert 0 < len(e.value.message_stack) < 8


def test_available_devices_lists_cpu():
    devices = koala_tpu_torch.available_devices()
    assert any(d.startswith("cpu:[0-") for d in devices), devices
