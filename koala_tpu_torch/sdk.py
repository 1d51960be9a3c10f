"""SDK client tagging + in-process license analogs.

``set_sdk``/``get_sdk`` mirror the reference runtime's pv_set_sdk/pv_get_sdk
(reference: include/picovoice.h:88-93; called by every binding at load, e.g.
binding/python/_koala.py:156-160) — a label identifying which client surface
is driving the engine, used for diagnostics.

The reference's AccessKey licensing is a networked service with four
ACTIVATION_* failure states (reference include/picovoice.h:50-53). This
framework has no license server; the equivalents are local and deterministic:

  ACTIVATION_ERROR     malformed AccessKey            (engine/stream.py)
  ACTIVATION_REFUSED   key on the local revocation list
                       (``KOALA_TPU_REVOKED_KEYS``, comma-separated)
  ACTIVATION_LIMIT     server configured beyond the local stream-slot quota
                       (``KOALA_TPU_MAX_STREAMS``)                (serve.py)
  ACTIVATION_THROTTLED all serving slots busy when a client connects
                       (StreamingServer.acquire_slot)             (serve.py)
"""

from __future__ import annotations

import os
import threading

from .errors import ERROR_STACK, KoalaActivationRefusedError, raise_with_stack

_lock = threading.Lock()
_sdk = "python"


def set_sdk(sdk: str) -> None:
    """Tag the calling SDK surface (analog of pv_set_sdk)."""
    global _sdk
    if isinstance(sdk, str) and sdk:
        with _lock:
            _sdk = sdk


def get_sdk() -> str:
    """Current SDK tag (analog of pv_get_sdk)."""
    with _lock:
        return _sdk


def check_revocation(access_key: str) -> None:
    """Raise ACTIVATION_REFUSED if the key is locally revoked."""
    revoked = os.environ.get("KOALA_TPU_REVOKED_KEYS", "")
    if revoked and access_key in {k.strip() for k in revoked.split(",") if k.strip()}:
        ERROR_STACK.push("AccessKey `%s...` has been revoked" % access_key[:4])
        ERROR_STACK.push("Failed to validate AccessKey")
        raise_with_stack(KoalaActivationRefusedError, "Initialization failed")


def max_streams_quota() -> int:
    """Local stream-slot quota (0 = unlimited), the ACTIVATION_LIMIT bound."""
    try:
        return int(os.environ.get("KOALA_TPU_MAX_STREAMS", "0"))
    except ValueError:
        return 0


__all__ = ["set_sdk", "get_sdk", "check_revocation", "max_streams_quota"]
