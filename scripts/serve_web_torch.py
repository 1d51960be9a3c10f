"""Web demo server on PyTorch: static page + WebSocket PCM streaming.

The koala_tpu_torch counterpart of scripts/serve_web.py, with the same
page (demo/web/index.html), wire protocol, flags and delay compensation.
The engine runs on the serving host (the CUDA card unless --device cpu is
given) and the browser streams raw int16 PCM frames over a WebSocket:

  browser -> ws: binary messages, little-endian int16 mono 16 kHz samples
  ws -> browser: enhanced int16 samples (delay-compensated server-side,
                 like scripts/serve_tcp_torch.py)
  browser sends the text message "eof" -> server drains the delay tail and
  replies with the text message "done".

Usage: python scripts/serve_web_torch.py [--port 8077] [--streams 16] [--device best]
Then open http://127.0.0.1:8077/ .
"""

import argparse
import http.server
import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

WEB_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "demo", "web")


def ws_client(conn, server, stream_id):
    from koala_tpu_torch.constants import FRAME_LENGTH
    from koala_tpu_torch.websocket import (
        OP_BINARY, OP_CLOSE, OP_PING, OP_PONG, OP_TEXT,
        recv_frame, send_frame, send_close)

    frame_bytes = FRAME_LENGTH * 2
    to_drop = server.delay_sample
    received = 0
    sent = 0
    buf = b""

    def pump(until=None):
        nonlocal to_drop, sent
        while True:
            out = server.pull(stream_id)
            if len(out):
                if to_drop:
                    cut = min(to_drop, len(out))
                    out = out[cut:]
                    to_drop -= cut
                if until is not None and sent + len(out) > until:
                    out = out[:until - sent]
                if len(out):
                    send_frame(conn, out.astype("<i2").tobytes())
                    sent += len(out)
            elif until is None or sent >= until:
                return
            else:
                time.sleep(0.002)

    def drain():
        """While the stream's input ring is full: send what is ready, and
        read nothing, so TCP's flow control holds a client that sends faster
        than the server runs (its audio is not dropped)."""
        pump()
        time.sleep(0.002)


    try:
        while True:
            opcode, payload = recv_frame(conn)
            if opcode is None or opcode == OP_CLOSE:
                return
            if opcode == OP_PING:
                send_frame(conn, payload, OP_PONG)
                continue
            if opcode == OP_TEXT and payload == b"eof":
                if buf:
                    part = np.frombuffer(buf, dtype="<i2")
                    tail = np.zeros(FRAME_LENGTH, np.int16)
                    tail[:len(part)] = part
                    server.push_all(stream_id, tail, drain)
                    received += len(part)
                    buf = b""
                flush = -(-server.delay_sample // FRAME_LENGTH) + 1
                server.push_all(stream_id, np.zeros(flush * FRAME_LENGTH, np.int16), drain)
                pump(until=received)
                send_frame(conn, b"done", OP_TEXT)
                continue
            if opcode != OP_BINARY:
                continue
            buf += payload
            n_frames = len(buf) // frame_bytes
            if n_frames:
                samples = np.frombuffer(buf[:n_frames * frame_bytes], dtype="<i2")
                buf = buf[n_frames * frame_bytes:]
                server.push_all(stream_id, samples, drain)
                received += len(samples)
            pump()
    except (ConnectionError, BrokenPipeError, OSError):
        pass
    finally:
        send_close(conn)
        try:
            conn.close()
        finally:
            server.release_slot(stream_id)


def run_ws_acceptor(sock, server):
    from koala_tpu_torch.errors import KoalaActivationThrottledError
    from koala_tpu_torch.websocket import handshake

    while True:
        try:
            conn, addr = sock.accept()
        except OSError:
            return
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

        def serve(conn=conn, addr=addr):
            path = handshake(conn)
            if path is None:
                conn.close()
                return
            try:
                stream_id = server.acquire_slot()
            except KoalaActivationThrottledError as e:
                print("throttled %s: %s" % (addr, e), flush=True)
                conn.close()
                return
            ws_client(conn, server, stream_id)

        threading.Thread(target=serve, daemon=True).start()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8077)
    ap.add_argument("--ws-port", type=int, default=None,
                    help="WebSocket port (default: port+1)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--access_key", default="WEBDEMO0" * 2)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--device", default="best")
    args = ap.parse_args()
    ws_port = args.ws_port or args.port + 1

    from koala_tpu_torch.sdk import set_sdk
    from koala_tpu_torch.serve import StreamingServer

    set_sdk("web")
    server = StreamingServer(args.access_key, num_streams=args.streams,
                             model_path=args.model_path, device=args.device)

    ws_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ws_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ws_sock.bind((args.host, ws_port))
    ws_sock.listen(64)
    threading.Thread(target=run_ws_acceptor, args=(ws_sock, server),
                     daemon=True).start()

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=WEB_ROOT, **kw)

        def log_message(self, *a):
            pass

        def end_headers(self):
            self.send_header("X-Koala-WS-Port", str(ws_port))
            super().end_headers()

    httpd = http.server.ThreadingHTTPServer((args.host, args.port), Handler)
    print("koala_tpu_torch web demo: http://%s:%d/  (ws :%d, %d stream slots)"
          % (args.host, args.port, ws_port, args.streams), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        ws_sock.close()
        server.close()


if __name__ == "__main__":
    main()
