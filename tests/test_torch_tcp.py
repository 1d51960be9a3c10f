"""The port's network fronts on the CPU: scripts/serve_tcp_torch.py and
scripts/serve_web_torch.py as subprocesses (the analogs of
tests/test_tcp_server.py and tests/test_web_demo.py), on the bundled model."""

import base64
import hashlib
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import koala_tpu_torch
from koala_tpu_torch.constants import FRAME_LENGTH

from torch_ref import ACCESS_KEY, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_S = 60


def _start(script, port, probe_port, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", script), "--port", str(port),
         "--streams", "4", "--device", "cpu", *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + START_S
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", probe_port), timeout=1).close()
            return proc
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError("server died: " + proc.stdout.read())
            time.sleep(0.2)
    proc.kill()
    raise RuntimeError("%s did not start within %d s" % (script, START_S))


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture(scope="module")
def tcp_port():
    port = free_port()
    proc = _start("serve_tcp_torch.py", port, port)
    yield port
    _stop(proc)


@pytest.fixture(scope="module")
def web_port():
    port = free_port()
    while True:
        ws = port + 1
        try:
            socket.socket().bind(("127.0.0.1", ws))
            break
        except OSError:
            port = free_port()
    proc = _start("serve_web_torch.py", port, port + 1)
    yield port
    _stop(proc)


def _direct(pcm):
    """The port's engine on one stream, delay-compensated as the fronts are
    (``Koala.enhance``)."""
    k = koala_tpu_torch.create(ACCESS_KEY, device="cpu")
    try:
        return k.enhance(pcm)
    finally:
        k.delete()


def _assert_lsb(got, ref):
    """tests/test_web_demo.py's bound: 2 LSB, and more than 1 LSB on at most
    a handful of samples (a batched pool sums in another order)."""
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert np.count_nonzero(diff > 1) <= max(2, len(diff) // 1000)


def _speech_like(n, rng):
    t = np.arange(n) / 16000.0
    x = sum(0.3 / k * np.sin(2 * np.pi * 150.0 * k * t + rng.uniform(0, 6)) for k in range(1, 9))
    x *= 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return np.clip(x * 12000, -32768, 32767).astype(np.int16)


def _through_tcp(port, pcm):
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        s.sendall(pcm.astype("<i2").tobytes())
        s.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            data = s.recv(65536)
            if not data:
                break
            chunks.append(data)
    finally:
        s.close()
    return np.frombuffer(b"".join(chunks), dtype="<i2")


def test_tcp_round_trip(tcp_port, rng):
    pcm = _speech_like(5000, rng)
    out = _through_tcp(tcp_port, pcm)
    assert out.shape == pcm.shape          # aligned 1:1, delay compensated
    assert np.any(out != 0)
    _assert_lsb(out, _direct(pcm))


def test_tcp_concurrent_clients(tcp_port, rng):
    pcms = [(rng.standard_normal(4000) * 5000).astype(np.int16) for _ in range(2)]
    outs = [None] * 2

    def run(i):
        outs[i] = _through_tcp(tcp_port, pcms[i])

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(2):
        assert outs[i] is not None and outs[i].shape == pcms[i].shape
        _assert_lsb(outs[i], _direct(pcms[i]))


def test_c_client_demo(tcp_port, tmp_path, rng):
    """demo/c/koala_client_demo.c, built into the test's own directory, run
    against the port's TCP front (tests/test_tcp_server.py's checks against
    the JAX front): exit 0, the real-time-factor line, nothing on stderr,
    and a reply of the input's shape, here also within 2 LSB of the engine."""
    from koala_tpu_torch.io import read_wav, write_wav

    client = str(tmp_path / "koala_client_demo")
    build = subprocess.run(["gcc", "-O2", "-Wall", "-Wextra", "-o", client,
                            os.path.join(REPO, "demo", "c", "koala_client_demo.c")],
                           capture_output=True, text=True, timeout=120)
    assert build.returncode == 0, build.stderr
    pcm = (rng.standard_normal(8000) * 6000).astype(np.int16)
    in_wav, out_wav = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    write_wav(in_wav, pcm)
    run = subprocess.run([client, in_wav, out_wav, "127.0.0.1", str(tcp_port)],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "Real time factor" in run.stdout
    assert run.stderr == ""
    out = read_wav(out_wav)
    assert out.shape == pcm.shape
    _assert_lsb(out, _direct(pcm))


def _ws_connect(port):
    conn = socket.create_connection(("127.0.0.1", port), timeout=60)
    key = base64.b64encode(os.urandom(16)).decode()
    conn.sendall(("GET / HTTP/1.1\r\nHost: 127.0.0.1:%d\r\nUpgrade: websocket\r\n"
                  "Connection: Upgrade\r\nSec-WebSocket-Key: %s\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n" % (port, key)).encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = conn.recv(4096)
        assert chunk, "server closed during the handshake"
        resp += chunk
    assert b"101" in resp.split(b"\r\n", 1)[0], resp
    accept = base64.b64encode(hashlib.sha1(
        (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
    assert accept in resp
    return conn


def _ws_send(conn, payload, opcode=2):
    mask = os.urandom(4)
    n = len(payload)
    if n < 126:
        head = struct.pack(">BB", 0x80 | opcode, 0x80 | n)
    else:
        head = struct.pack(">BBH", 0x80 | opcode, 0x80 | 126, n)
    conn.sendall(head + mask + bytes(c ^ mask[i % 4] for i, c in enumerate(payload)))


def _recv_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _ws_recv(conn):
    hdr = _recv_exact(conn, 2)
    if hdr is None:
        return None, b""
    length = hdr[1] & 0x7F
    if length == 126:
        length = struct.unpack(">H", _recv_exact(conn, 2))[0]
    elif length == 127:
        length = struct.unpack(">Q", _recv_exact(conn, 8))[0]
    return hdr[0] & 0x0F, (_recv_exact(conn, length) if length else b"") or b""


def _through_websocket(port, pcm):
    """``pcm`` through the WebSocket protocol in messages of 16 frames, then
    "eof"; returns the binary replies up to "done"."""
    conn = _ws_connect(port)
    try:
        for i in range(0, len(pcm), FRAME_LENGTH * 16):
            _ws_send(conn, pcm[i:i + FRAME_LENGTH * 16].astype("<i2").tobytes())
        _ws_send(conn, b"eof", opcode=1)
        out = b""
        while True:
            opcode, payload = _ws_recv(conn)
            assert opcode is not None, "connection dropped"
            if opcode == 1 and payload == b"done":
                break
            if opcode == 2:
                out += payload
            if opcode == 8:
                break
    finally:
        conn.close()
    return np.frombuffer(out, dtype="<i2")


def test_websocket_round_trip_matches_direct_engine(web_port, rng):
    n = FRAME_LENGTH * 40
    pcm = (rng.standard_normal(n) * 3000).astype(np.int16)
    _assert_lsb(_through_websocket(web_port + 1, pcm), _direct(pcm))


@pytest.mark.parametrize("front", ["tcp", "websocket"])
def test_front_takes_a_stream_longer_than_its_ring(front, tcp_port, web_port, rng):
    """A client that sends a whole file at once, longer than a stream's input
    ring (256 frames): the front waits for room instead of dropping audio,
    so the reply is whole and within 2 LSB of the engine (it hung at EOF,
    waiting for output of the audio its full ring had dropped)."""
    pcm = _speech_like(300 * FRAME_LENGTH + 77, rng)
    out = _through_tcp(tcp_port, pcm) if front == "tcp" else _through_websocket(web_port + 1, pcm)
    assert out.shape == pcm.shape
    _assert_lsb(out, _direct(pcm))


def test_http_serves_the_demo_page(web_port):
    with urllib.request.urlopen("http://127.0.0.1:%d/" % web_port, timeout=10) as r:
        body = r.read().decode()
        assert r.headers["X-Koala-WS-Port"] == str(web_port + 1)
    assert "koala_tpu" in body and "WebSocket" in body
