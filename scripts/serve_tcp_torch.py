"""TCP streaming enhancement service over the batched engine, on PyTorch.

The koala_tpu_torch counterpart of scripts/serve_tcp.py, with the same wire
protocol, flags and delay compensation: clients stream raw int16 frames
over a socket and receive enhanced frames back, while one device batches
all live connections (koala_tpu_torch.serve.StreamingServer). It runs on
the CUDA card unless --device cpu is given.

Wire protocol (one stream per connection, little-endian):
  client -> server: raw int16 mono 16 kHz samples, any chunking
  server -> client: enhanced int16 samples (delayed by delay_sample)
  client half-closes (shutdown(SHUT_WR)) -> server flushes the delay tail
  (zero-frame drain, the reference's stop-flush pattern) and closes.

Usage: python scripts/serve_tcp_torch.py [--port 7532] [--streams 64] [--device best]
                                        [--chunk_frames 32]
"""

import argparse
import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def handle_client(conn, addr, server, stream_id):
    """One stream. The server performs delay compensation: the first
    delay_sample output samples (warmup) are dropped and the stream is
    drained with zero frames at EOF (the reference's file-demo algorithm,
    demo/python/koala_demo_file.py:96-116), so the client receives exactly
    len(input) aligned enhanced samples."""
    from koala_tpu_torch.constants import FRAME_LENGTH

    frame_bytes = FRAME_LENGTH * 2
    state = {"to_drop": server.delay_sample, "sent": 0}
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        buf = b""
        received = 0

        def pump_out(until=None):
            while True:
                out = server.pull(stream_id)
                if len(out):
                    if state["to_drop"]:
                        cut = min(state["to_drop"], len(out))
                        out = out[cut:]
                        state["to_drop"] -= cut
                    if until is not None and state["sent"] + len(out) > until:
                        out = out[:until - state["sent"]]
                    if len(out):
                        conn.sendall(out.astype("<i2").tobytes())
                        state["sent"] += len(out)
                elif until is None or state["sent"] >= until:
                    return
                else:
                    time.sleep(0.002)

        def drain():
            """While the stream's input ring is full: send what is ready, and
            read nothing, so TCP's flow control holds a client that sends
            faster than the server runs (its audio is not dropped)."""
            pump_out()
            time.sleep(0.002)


        while True:
            data = conn.recv(65536)
            if not data:
                break
            buf += data
            n_frames = len(buf) // frame_bytes
            if n_frames:
                samples = np.frombuffer(buf[:n_frames * frame_bytes], dtype="<i2")
                buf = buf[n_frames * frame_bytes:]
                server.push_all(stream_id, samples, drain)
                received += len(samples)
            pump_out()

        # half-close: pad the final partial frame, then feed zero frames
        # until the delayed tail is flushed.
        if buf:
            part = np.frombuffer(buf, dtype="<i2")
            tail = np.zeros(FRAME_LENGTH, np.int16)
            tail[:len(part)] = part
            server.push_all(stream_id, tail, drain)
            received += len(part)
        flush_frames = -(-server.delay_sample // FRAME_LENGTH) + 1
        server.push_all(stream_id, np.zeros(flush_frames * FRAME_LENGTH, np.int16), drain)
        pump_out(until=received)
    except (ConnectionError, BrokenPipeError):
        pass
    finally:
        try:
            conn.close()
        finally:
            server.release_slot(stream_id)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=7532)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--access_key", default="SERVEKEY" * 2)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--device", default="best")
    ap.add_argument("--chunk_frames", type=int, default=32,
                    help="frames per stream in one backlog round")
    args = ap.parse_args()

    from koala_tpu_torch.errors import KoalaActivationThrottledError
    from koala_tpu_torch.sdk import set_sdk
    from koala_tpu_torch.serve import StreamingServer

    set_sdk("tcp-service")
    server = StreamingServer(args.access_key, num_streams=args.streams,
                             model_path=args.model_path, device=args.device,
                             chunk_frames=args.chunk_frames)

    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((args.host, args.port))
    sock.listen(128)
    print("koala_tpu_torch serving on %s:%d (%d stream slots)"
          % (args.host, args.port, args.streams), flush=True)

    try:
        while True:
            conn, addr = sock.accept()
            try:
                stream_id = server.acquire_slot()
            except KoalaActivationThrottledError as e:
                # Typed admission rejection (ACTIVATION_THROTTLED) instead
                # of a silent close; logged server-side, client sees EOF
                # before any enhanced audio.
                print("throttled %s: %s" % (addr, e), flush=True)
                conn.close()
                continue
            threading.Thread(target=handle_client,
                             args=(conn, addr, server, stream_id),
                             daemon=True).start()
    except KeyboardInterrupt:
        pass
    finally:
        sock.close()
        server.close()
        print("stats:", server.stats)


if __name__ == "__main__":
    main()
