"""The port's StreamingServer (koala_tpu_torch/serve.py) on the CPU: the
analogs of tests/test_serve.py, over the same three models (mmse, untrained
mask_gru, the bundled model), held against koala_tpu at the JAX tests'
tolerances."""

import time

import numpy as np
import pytest

import koala_tpu
from koala_tpu_torch.constants import FRAME_LENGTH
from koala_tpu_torch.serve import StreamingServer

from torch_ref import assert_near_jax


def _drain(server, stream, expected_samples, timeout=30.0):
    out = []
    total = 0
    deadline = time.time() + timeout
    while total < expected_samples and time.time() < deadline:
        chunk = server.pull(stream)
        if len(chunk):
            out.append(chunk)
            total += len(chunk)
        else:
            time.sleep(0.005)
    return np.concatenate(out) if out else np.zeros((0,), np.int16)


def _jax_direct(access_key, model, pcm):
    """koala_tpu's single-stream engine, one process() call a frame."""
    k = koala_tpu.create(access_key, model_path=model, device="cpu")
    try:
        return np.concatenate([
            np.asarray(k.process(pcm[s:s + FRAME_LENGTH].tolist()), np.int16)
            for s in range(0, len(pcm), FRAME_LENGTH)])
    finally:
        k.delete()


def _server(access_key, model, **kw):
    return StreamingServer(access_key, model_path=model, device="cpu", **kw)


def test_server_matches_direct_stream(access_key, serve_model, rng):
    """Frames served through the async pipeline match koala_tpu's
    single-stream engine (``assert_near_jax``)."""
    t = 12
    pcm = (rng.standard_normal(t * FRAME_LENGTH) * 6000).astype(np.int16)
    direct = _jax_direct(access_key, serve_model, pcm)
    server = _server(access_key, serve_model, num_streams=4)
    try:
        server.push(2, pcm)
        served = _drain(server, 2, len(pcm))
    finally:
        server.close()
    assert_near_jax(served, direct)


def test_server_interleaved_streams(access_key, serve_model, rng):
    """Two streams at different push cadences both come out right."""
    t = 8
    pcm0 = (rng.standard_normal(t * FRAME_LENGTH) * 5000).astype(np.int16)
    pcm1 = (rng.standard_normal(t * FRAME_LENGTH) * 5000).astype(np.int16)
    server = _server(access_key, serve_model, num_streams=2)
    try:
        # stream 0 gets everything at once; stream 1 dribbles frame by frame
        server.push(0, pcm0)
        for s in range(0, len(pcm1), FRAME_LENGTH):
            server.push(1, pcm1[s:s + FRAME_LENGTH])
            time.sleep(0.002)
        out0 = _drain(server, 0, len(pcm0))
        out1 = _drain(server, 1, len(pcm1))
    finally:
        server.close()
    for pcm, out in ((pcm0, out0), (pcm1, out1)):
        assert_near_jax(out, _jax_direct(access_key, serve_model, pcm))


def test_close_drains_inflight_output(access_key, serve_model, rng):
    """close() routes the last in-flight device step instead of dropping it."""
    t = 40     # enough for the chunked backlog path
    pcm = (rng.standard_normal(t * FRAME_LENGTH) * 5000).astype(np.int16)
    server = _server(access_key, serve_model, num_streams=2, chunk_frames=16)
    try:
        server.push(0, pcm)
        # wait until every frame was processed (stats), without pulling
        deadline = time.time() + 30
        while server.stats["frames_processed"] < t and time.time() < deadline:
            time.sleep(0.005)
    finally:
        server.close()
    out = server.pull(0)
    assert len(out) == t * FRAME_LENGTH, len(out)


def test_reset_drops_inflight_output(access_key, serve_model, rng):
    """After reset(stream), no pre-reset audio surfaces, not even audio in
    flight in the dispatch pipeline when the reset landed."""
    t = 64
    pcm = (rng.standard_normal(t * FRAME_LENGTH) * 5000).astype(np.int16)
    server = _server(access_key, serve_model, num_streams=2, chunk_frames=32)
    try:
        for trial in range(5):
            server.push(0, pcm)
            time.sleep(0.01)        # let a chunked dispatch get in flight
            server.reset(0)
            time.sleep(0.1)         # give stale routing a chance to land
            stale = server.pull(0)
            # a sliver that raced the reset call itself is acceptable (the
            # JAX test's bound); a whole in-flight chunk (32 frames) is not
            assert len(stale) <= 8 * FRAME_LENGTH, (trial, len(stale))
            server.reset(0)
    finally:
        server.close()


def test_server_reset_stream(access_key, serve_model, rng):
    """A reset stream reproduces its first output bit for bit."""
    t = 6
    pcm = (rng.standard_normal(t * FRAME_LENGTH) * 5000).astype(np.int16)
    server = _server(access_key, serve_model, num_streams=2)
    try:
        server.push(0, pcm)
        first = _drain(server, 0, len(pcm))
        server.reset(0)
        server.push(0, pcm)
        second = _drain(server, 0, len(pcm))
        assert len(first) == len(pcm)
        np.testing.assert_array_equal(first, second)
        assert server.stats["frames_processed"] >= 2 * t
    finally:
        server.close()


def test_server_multi_device_shards(access_key, serve_model, rng):
    """devices=4 splits the slots into 4 CPU shards, each with its own
    parameters and state; every stream matches the one-shard server within
    1 LSB (the JAX test's tolerance across shard batch sizes)."""
    t = 10
    streams = 8
    pcm = [(rng.standard_normal(t * FRAME_LENGTH) * 5000).astype(np.int16)
           for _ in range(streams)]
    ref_server = _server(access_key, serve_model, num_streams=streams)
    try:
        for i in range(streams):
            ref_server.push(i, pcm[i])
        ref = [_drain(ref_server, i, len(pcm[i])) for i in range(streams)]
    finally:
        ref_server.close()

    server = _server(access_key, serve_model, num_streams=streams, devices=4)
    try:
        assert server.stats["devices"] == 4
        assert [(s.lo, s.hi) for s in server._shards] == [(0, 2), (2, 4), (4, 6), (6, 8)]
        for i in range(streams):
            server.push(i, pcm[i])
        for i in range(streams):
            out = _drain(server, i, len(pcm[i]))
            assert out.shape == ref[i].shape, i
            np.testing.assert_allclose(out, ref[i], atol=1, err_msg=str(i))
    finally:
        server.close()


def test_server_batched_push_pull(access_key, serve_model, rng):
    """push_block / pull_block move the whole pool's audio in one native hop
    each and agree with per-stream push / pull bit for bit."""
    t = 12
    streams = 4
    rows = (rng.standard_normal((streams, t, FRAME_LENGTH)) * 5000).astype(np.int16)
    counts = np.full((streams,), t, np.int32)

    ref_server = _server(access_key, serve_model, num_streams=streams)
    try:
        for i in range(streams):
            ref_server.push(i, rows[i].reshape(-1))
        ref = [_drain(ref_server, i, t * FRAME_LENGTH) for i in range(streams)]
    finally:
        ref_server.close()

    server = _server(access_key, serve_model, num_streams=streams)
    try:
        assert server.push_block(rows, counts) == streams * t
        got = [[] for _ in range(streams)]
        need = streams * t
        deadline = time.time() + 30
        while need > 0 and time.time() < deadline:
            out_rows, out_counts = server.pull_block(max_frames=t)
            for i in range(streams):
                c = int(out_counts[i])
                if c:
                    got[i].append(out_rows[i, :c].copy().reshape(-1))
                    need -= c
            if need > 0:
                time.sleep(0.005)
        for i in range(streams):
            out = np.concatenate(got[i]) if got[i] else np.zeros(0, np.int16)
            np.testing.assert_array_equal(out, ref[i], err_msg=str(i))
    finally:
        server.close()


@pytest.mark.parametrize("devices", [0, 9, "many"])
def test_bad_devices_argument_raises(access_key, mmse_model, devices):
    from koala_tpu_torch import KoalaInvalidArgumentError

    with pytest.raises((KoalaInvalidArgumentError, ValueError)):
        _server(access_key, mmse_model, num_streams=8, devices=devices)


def test_a_failed_round_stops_the_server_and_close_reports_it(access_key, mmse_model, rng,
                                                              monkeypatch):
    """A device round that raises stops the dispatch thread; close() raises
    KoalaRuntimeError instead of leaving the caller waiting on silence."""
    from koala_tpu_torch import KoalaRuntimeError
    from koala_tpu_torch.engine.core import Engine

    def broken(*args, **kwargs):
        raise RuntimeError("device round failed")

    monkeypatch.setattr(Engine, "chunk_masked", broken)
    server = _server(access_key, mmse_model, num_streams=2)
    server.push(0, (rng.standard_normal(FRAME_LENGTH) * 3000).astype(np.int16))
    deadline = time.time() + 30
    while server._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not server._thread.is_alive()
    with pytest.raises(KoalaRuntimeError):
        server.close()
    assert server.stats["frames_processed"] == 0
