"""The rest of the public surface on the CPU: the mmse and identity models
through every entry point (``Koala.process``, ``Koala.enhance``,
``KoalaBatch.process``, ``process_chunk``, ``enhance``) and state snapshots
taken mid-stream, held against koala_tpu on the same model files (the
session fixtures of tests/conftest.py) and the same seeded input.

Outputs are held to the server tests' cross-package tolerance
(``torch_ref.assert_near_jax``: 2 LSB, at most 0.1% of samples at 3); the
identity model, a unit mask, must give the input back delayed by exactly
``delay_sample`` (and ``enhance`` the input itself) in the port."""

import os

import numpy as np
import pytest

import koala_tpu
import koala_tpu_torch
from koala_tpu_torch.constants import DELAY_SAMPLE, FRAME_LENGTH
from koala_tpu_torch.engine.stream import load_model
from koala_tpu_torch.io import read_wav
from koala_tpu_torch.models import params_io

from torch_ref import ACCESS_KEY, assert_near_jax

AUDIO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources",
                     "audio_samples")
FRAMES = 24                   # frames a stream
CUT = 16                      # the snapshot's cut, a multiple of 8 (enhance's fused plan)
ENTRIES = ("Koala.process", "Koala.enhance", "KoalaBatch.process", "process_chunk", "enhance")


def _pcm(batch, n, seed):
    """Seeded int16 streams: noise at two levels, with a burst at full scale
    in the middle (the saturating edge of both PCM conversions)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)) * np.where(np.arange(n) < n // 2, 3000.0, 9000.0)
    x[:, n // 3:n // 3 + 300] *= 6.0
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def _mix(batch, n):
    """``batch`` streams of the committed synth speech + noise mix (the
    input of tests/test_torch_api.py), each from another offset. The bundled
    model is held to koala_tpu on speech: on white noise with bursts at full
    scale the two packages' bf16 GRU roundings part further than the
    tolerance while every feature agrees to float32 rounding, as ROADMAP.md
    section 3 records."""
    speech = read_wav(os.path.join(AUDIO, "speech_synth.wav")).astype(np.int32)
    noise = read_wav(os.path.join(AUDIO, "noise_synth.wav")).astype(np.int32)
    m = min(len(speech), len(noise))
    mix = np.clip(speech[:m] + noise[:m], -32768, 32767).astype(np.int16)
    return np.stack([mix[i * 9001:i * 9001 + n] for i in range(batch)])


def run_entry(pkg, model_path, entry, pcm):
    """``pcm`` [B, N] through one entry point of ``pkg`` (koala_tpu or the
    port) on the CPU: the single-stream entries one stream at a time from a
    reset, ``process_chunk`` in two chunks (the state carried across).
    Returns [B, N] int16."""
    b, n = pcm.shape
    if entry.startswith("Koala."):
        k = pkg.create(ACCESS_KEY, model_path=model_path, device="cpu")
        try:
            rows = []
            for row in pcm:
                k.reset()
                if entry == "Koala.process":
                    rows.append(np.concatenate([np.asarray(k.process(row[s:s + FRAME_LENGTH]
                                                                     .tolist()), np.int16)
                                                for s in range(0, n, FRAME_LENGTH)]))
                else:
                    rows.append(np.asarray(k.enhance(row)))
            return np.stack(rows)
        finally:
            k.delete()
    kb = pkg.create_batch(ACCESS_KEY, batch_size=b, model_path=model_path, device="cpu")
    try:
        if entry == "KoalaBatch.process":
            return np.concatenate([np.asarray(kb.process(pcm[:, s:s + FRAME_LENGTH]))
                                   for s in range(0, n, FRAME_LENGTH)], axis=1)
        if entry == "process_chunk":
            cut = n // FRAME_LENGTH // 2 * FRAME_LENGTH
            return np.concatenate([np.asarray(kb.process_chunk(pcm[:, :cut])),
                                   np.asarray(kb.process_chunk(pcm[:, cut:]))], axis=1)
        return np.asarray(kb.enhance(pcm))
    finally:
        kb.delete()


@pytest.fixture(scope="module")
def model_files(mmse_model, identity_model):
    return {"mmse": mmse_model, "identity": identity_model}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("model", ["mmse", "identity"])
def test_entry_matches_jax(model_files, model, entry, batch):
    path = model_files[model]
    n = FRAMES * FRAME_LENGTH - (100 if entry.endswith("enhance") else 0)
    pcm = _pcm(batch, n, seed=10 * ENTRIES.index(entry) + batch + (model == "mmse"))
    got = run_entry(koala_tpu_torch, path, entry, pcm)
    want = run_entry(koala_tpu, path, entry, pcm)
    assert got.shape == want.shape == pcm.shape and got.dtype == np.int16
    for g, w in zip(got, want):
        assert_near_jax(g, w)
    if model == "identity":
        # a unit mask: the port gives the input back exactly, delayed by one
        # hop on the streaming entries, aligned 1:1 by enhance
        if entry.endswith("enhance"):
            np.testing.assert_array_equal(got, pcm)
        else:
            np.testing.assert_array_equal(got[:, DELAY_SAMPLE:], pcm[:, :-DELAY_SAMPLE])
            assert not got[:, :DELAY_SAMPLE].any()


def _halves(pkg, model_path, mode, pcm, snap=None):
    """The first CUT frames of ``pcm`` through ``mode`` in one instance of
    ``pkg``, then its snapshot, then the rest (from ``snap`` in a fresh
    instance when one is given). Returns (first, snapshot, second)."""
    b = pcm.shape[0]
    run = (lambda kb, x: kb.process_chunk(x)) if mode == "process_chunk" \
        else (lambda kb, x: kb.enhance(x))
    kb = pkg.create_batch(ACCESS_KEY, batch_size=b, model_path=model_path, device="cpu")
    try:
        first = np.asarray(run(kb, pcm[:, :CUT * FRAME_LENGTH]))
        taken = kb.save_state()
        if snap is not None:
            kb.delete()
            kb = pkg.create_batch(ACCESS_KEY, batch_size=b, model_path=model_path, device="cpu")
            kb.load_state(snap)
        return first, taken, np.asarray(run(kb, pcm[:, CUT * FRAME_LENGTH:]))
    finally:
        kb.delete()


@pytest.mark.parametrize("mode", ["process_chunk", "enhance"])
@pytest.mark.parametrize("model", ["mmse", "bundled"])
def test_snapshot_moves_across_packages(model_files, model, mode):
    """A stream cut mid-way: the port's snapshot resumes in koala_tpu and
    koala_tpu's in the port, each within the cross-package tolerance of the
    other's uninterrupted run (both halves in one instance); the snapshot has
    koala_tpu's keys, shapes and float32 leaves; and a port snapshot carried
    through koala_tpu and back resumes the port bit for bit."""
    path = model_files["mmse"] if model == "mmse" else params_io.default_model_path()
    pcm = _mix(3, (CUT + 9) * FRAME_LENGTH)
    p_first, p_snap, p_second = _halves(koala_tpu_torch, path, mode, pcm)
    j_first, j_snap, j_second = _halves(koala_tpu, path, mode, pcm)
    for got, want in ((p_first, j_first), (p_second, j_second)):
        for g, w in zip(got, want):
            assert_near_jax(g, w)

    assert set(p_snap) == set(j_snap)
    for key, value in p_snap.items():
        assert value.dtype == np.float32 and value.shape == np.shape(j_snap[key]), key
        assert np.asarray(j_snap[key]).dtype == np.float32, key
    engine, _ = load_model(path, "cpu")
    fresh = params_io._flatten(engine.init_state((3,), "cpu"))
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in p_snap.items()}

    # the port's snapshot in koala_tpu, koala_tpu's in the port
    _, _, j_resumed = _halves(koala_tpu, path, mode, pcm, snap=p_snap)
    _, _, p_resumed = _halves(koala_tpu_torch, path, mode, pcm, snap=j_snap)
    for g, w in zip(j_resumed, j_second):
        assert_near_jax(g, w)
    for g, w in zip(p_resumed, p_second):
        assert_near_jax(g, w)

    # port -> koala_tpu -> port: the same bits, so the same stream
    kb = koala_tpu.create_batch(ACCESS_KEY, batch_size=3, model_path=path, device="cpu")
    kb.load_state(p_snap)
    back = kb.save_state()
    kb.delete()
    for key, value in p_snap.items():
        np.testing.assert_array_equal(np.asarray(back[key]), value, err_msg=key)
    _, _, p_back = _halves(koala_tpu_torch, path, mode, pcm, snap=back)
    np.testing.assert_array_equal(p_back, p_second)


def test_fused_enhance_snapshot_moves_across_packages():
    """The state a card's ``enhance`` leaves is the fused path's (made here by
    the fused entry's plain version, as the card's kernels compute it): the
    hops and spectra rounded to bf16, so the floor of a band the stream
    leaves empty sits at the rounding's level, far above the float32 path's
    (more than 1 apart in log energy on the rumble pair here), in koala_tpu's
    own fused mirror as in the port's. That snapshot resumes the float32 path
    of koala_tpu as it resumes the port's, within the cross-package
    tolerance, and has the engine's keys, shapes and float32 leaves."""
    from koala_tpu.ops.pallas.engine_fused import fused_sequence_ref as jfused_ref
    from koala_tpu_torch.engine.core import Engine

    speech = read_wav(os.path.join(AUDIO, "speech_dev7.wav"))
    noise = read_wav(os.path.join(AUDIO, "noise_dev7.wav"))
    n = (CUT + 9) * FRAME_LENGTH
    pcm = np.stack([speech[:n], noise[:n], np.clip(speech[:n].astype(np.int32) + noise[:n],
                                                   -32768, 32767).astype(np.int16)])
    path = params_io.default_model_path()
    port = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=3, model_path=path, device="cpu")
    port._engine = Engine(port._engine.kind, dict(port._engine.config, use_pallas=True))
    port.enhance(pcm[:, :CUT * FRAME_LENGTH])
    snap = port.save_state()
    port.delete()
    plain = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=3, model_path=path, device="cpu")
    plain.enhance(pcm[:, :CUT * FRAME_LENGTH])
    assert np.abs(plain.save_state()["model/floor"] - snap["model/floor"]).max() > 1.0
    plain.delete()
    engine, _ = load_model(path, "cpu")
    fresh = params_io._flatten(engine.init_state((3,), "cpu"))
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in snap.items()}
    assert all(v.dtype == np.float32 for v in snap.values())

    # koala_tpu's own fused mirror leaves the same state (its floor included)
    import jax.numpy as jnp

    jk = koala_tpu.create_batch(ACCESS_KEY, batch_size=3, model_path=path, device="cpu")
    hops = np.zeros((3, CUT + 1, FRAME_LENGTH), np.float32)
    hops[:, :CUT] = (pcm[:, :CUT * FRAME_LENGTH] / 32768.0).reshape(3, CUT, FRAME_LENGTH)
    tree, cfg = params_io.load_params(path)
    from koala_tpu.models import mask_gru as jmask

    cfg = dict(jmask.DEFAULT_CONFIG, **cfg)
    state, _ = jfused_ref(jk._params, jk._state, jnp.asarray(hops[:, :CUT]), cfg)
    state, _ = jk._engine.sequence(jk._params, state, jnp.asarray(hops[:, CUT:]))
    jk.delete()
    np.testing.assert_allclose(np.asarray(state["model"]["floor"]), snap["model/floor"],
                               atol=2e-2)
    np.testing.assert_allclose(np.asarray(state["ola"]), snap["ola"], atol=1e-4)

    rest = pcm[:, CUT * FRAME_LENGTH:]
    outs = []
    for pkg in (koala_tpu_torch, koala_tpu):
        kb = pkg.create_batch(ACCESS_KEY, batch_size=3, model_path=path, device="cpu")
        kb.load_state(snap)
        outs.append(np.asarray(kb.enhance(rest)))
        kb.delete()
    for g, w in zip(*outs):
        assert_near_jax(g, w)
