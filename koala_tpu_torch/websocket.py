"""Minimal RFC 6455 WebSocket server primitives (stdlib only).

Supports what the web demo needs: HTTP upgrade handshake, binary frames
(client->server masked, server->client unmasked), ping/pong, close. The
analog of the reference's browser transport (its WASM engine runs
in-page; ours runs on the serving host, so the browser streams PCM over
a socket — SURVEY.md §2 #8/#14).
"""

from __future__ import annotations

import base64
import hashlib
import socket
import struct
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


def handshake(conn: socket.socket) -> Optional[str]:
    """Perform the server side of the WS upgrade. Returns the request path,
    or None if the request was not a well-formed upgrade."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = conn.recv(4096)
        if not chunk:
            return None
        data += chunk
        if len(data) > 65536:
            return None
    head = data.split(b"\r\n\r\n", 1)[0].decode("latin-1")
    lines = head.split("\r\n")
    path = lines[0].split(" ")[1] if len(lines[0].split(" ")) > 1 else "/"
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key")
    if not key or "upgrade" not in headers.get("connection", "").lower():
        return None
    accept = base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()).decode()
    conn.sendall((
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        "Sec-WebSocket-Accept: %s\r\n\r\n" % accept).encode())
    return path


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_frame(conn: socket.socket) -> Tuple[Optional[int], bytes]:
    """-> (opcode, payload); (None, b\"\") on EOF/protocol error."""
    hdr = _recv_exact(conn, 2)
    if hdr is None:
        return None, b""
    b0, b1 = hdr
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    length = b1 & 0x7F
    if length == 126:
        ext = _recv_exact(conn, 2)
        if ext is None:
            return None, b""
        length = struct.unpack(">H", ext)[0]
    elif length == 127:
        ext = _recv_exact(conn, 8)
        if ext is None:
            return None, b""
        length = struct.unpack(">Q", ext)[0]
    mask = b""
    if masked:
        mask = _recv_exact(conn, 4)
        if mask is None:
            return None, b""
    payload = _recv_exact(conn, length) if length else b""
    if payload is None:
        return None, b""
    if masked and payload:
        payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    return opcode, payload


def send_frame(conn: socket.socket, payload: bytes,
               opcode: int = OP_BINARY) -> None:
    n = len(payload)
    if n < 126:
        head = struct.pack(">BB", 0x80 | opcode, n)
    elif n < 65536:
        head = struct.pack(">BBH", 0x80 | opcode, 126, n)
    else:
        head = struct.pack(">BBQ", 0x80 | opcode, 127, n)
    conn.sendall(head + payload)


def send_close(conn: socket.socket) -> None:
    try:
        send_frame(conn, b"", OP_CLOSE)
    except OSError:
        pass


__all__ = ["handshake", "recv_frame", "send_frame", "send_close",
           "OP_BINARY", "OP_TEXT", "OP_CLOSE", "OP_PING", "OP_PONG"]
