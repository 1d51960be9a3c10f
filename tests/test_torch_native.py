"""The port's host library (koala_tpu_torch/hostlib.py) against the JAX
package's (koala_tpu/hostlib.py) over the same native sources, bit for bit,
and its build, which writes only under koala_tpu_torch/_build/."""

import os
import threading
import time

import numpy as np
import pytest

from koala_tpu import hostlib as jhost
from koala_tpu_torch import hostlib as thost
from koala_tpu_torch.errors import KoalaRuntimeError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")


def _tree_state(path):
    """Every file under ``path`` with its size and mtime."""
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            out[os.path.relpath(os.path.join(dirpath, f), path)] = (st.st_size, st.st_mtime_ns)
    return out


def test_build_writes_only_under_the_package_build_dir(tmp_path, monkeypatch):
    jhost.load_hostlib()                 # the reference's own library, built first
    before = _tree_state(NATIVE)
    monkeypatch.setattr(thost, "BUILD_DIR", str(tmp_path / "_build"))
    lib = thost.build()
    assert os.path.dirname(lib) == str(tmp_path / "_build") and os.path.exists(lib)
    assert os.listdir(tmp_path / "_build") == [os.path.basename(lib)]
    assert _tree_state(NATIVE) == before
    assert thost.BUILD_DIR.endswith("_build")
    assert thost.library_path().startswith(str(tmp_path / "_build"))


def test_failed_build_raises_typed_error(tmp_path, monkeypatch):
    monkeypatch.setattr(thost, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(thost, "CXXFLAGS", thost.CXXFLAGS + ["-fno-such-flag"])
    with pytest.raises(KoalaRuntimeError):
        thost.build()


def test_version():
    assert thost.load_hostlib().kt_host_version() == jhost.load_hostlib().kt_host_version()
    assert thost.load_hostlib().kt_host_version().decode().startswith("3.0.0")


def test_pcm_round_trip_and_rms_bit_identical(rng):
    pcm = (rng.standard_normal(10000) * 12000).astype(np.int16)
    f = thost.pcm_to_f32(pcm)
    np.testing.assert_array_equal(f, jhost.pcm_to_f32(pcm))
    np.testing.assert_array_equal(thost.f32_to_pcm(f), pcm)
    x = (rng.standard_normal(5000) * 0.7).astype(np.float32)    # saturates, rounds
    np.testing.assert_array_equal(thost.f32_to_pcm(x), jhost.f32_to_pcm(x))
    assert thost.rms(pcm) == jhost.rms(pcm)


def _both_pools(**kw):
    return thost.StreamPool(**kw), jhost.StreamPool(**kw)


def test_gather_and_gather_chunk_bit_identical(rng):
    pools = _both_pools(num_streams=4, frame_length=256, capacity_frames=8)
    data = (rng.standard_normal((4, 5 * 256)) * 1000).astype(np.int16)
    got = []
    for pool in pools:
        pool.push(0, data[0][:256])
        pool.push(1, data[1][:100])
        pool.push(2, data[2])
        batch, active, n = pool.gather()
        chunk, counts, total = pool.gather_chunk(3)
        got.append((batch.copy(), active.copy(), n, chunk.copy(), counts.copy(), total))
        pool.close()
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    batch, active, n, chunk, counts, total = got[0]
    assert n == 2 and list(active) == [True, False, True, False]
    assert list(counts) == [0, 0, 3, 0] and total == 3
    np.testing.assert_array_equal(chunk[2].reshape(-1), data[2][256:4 * 256])


def test_push_rows_and_pull_bit_identical(rng):
    rows = (rng.standard_normal((3, 4, 256)) * 3000).astype(np.int16)
    rows_f = (rng.standard_normal((3, 2, 256)) * 0.5).astype(np.float32)
    counts = np.array([4, 1, 0], np.int32)
    got = []
    for pool in _both_pools(num_streams=3, frame_length=256, capacity_frames=16):
        n = pool.push_rows(rows, counts)
        n_f = pool.push_rows_f32(rows_f, np.array([2, 2, 2], np.int32))
        got.append((n, n_f, [pool.pull(s, 16 * 256) for s in range(3)]))
        pool.close()
    (n, n_f, a), (m, m_f, b) = got
    assert (n, n_f) == (m, m_f) == (5, 6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[0][:4 * 256], rows[0].reshape(-1))


def test_overflow_accounting_matches(rng):
    dropped = []
    for pool in _both_pools(num_streams=1, frame_length=256, capacity_frames=2):
        assert not pool.push(0, np.zeros(256 * 64, np.int16))
        dropped.append(pool.dropped_samples)
        pool.close()
    assert dropped[0] == dropped[1] > 0


def test_reset_stream():
    pool = thost.StreamPool(num_streams=2, frame_length=256, capacity_frames=8)
    pool.push(0, np.ones(512, np.int16))
    pool.push(1, np.ones(512, np.int16))
    pool.reset_stream(0)
    assert pool.frames_ready(0) == 0
    assert pool.frames_ready(1) == 2
    pool.close()


def test_concurrent_producer(rng):
    """SPSC ring: a producer thread pushes while the consumer gathers."""
    frames = 200
    pool = thost.StreamPool(num_streams=1, frame_length=256, capacity_frames=16)
    src = (rng.standard_normal(frames * 256) * 5000).astype(np.int16)

    def producer():
        for i in range(frames):
            while pool.frames_ready(0) >= 15:
                time.sleep(0)
            pool.push(0, src[i * 256:(i + 1) * 256])

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    got = []
    deadline = time.time() + 60
    while len(got) < frames and time.time() < deadline:
        batch, active, n = pool.gather()
        if n:
            got.append(batch[0].copy())
    t.join(timeout=10)
    assert not t.is_alive() and len(got) == frames
    np.testing.assert_array_equal(np.concatenate(got), src)
    assert pool.dropped_samples == 0
    pool.close()
