"""Typed error hierarchy and status codes.

Reproduces the reference's cross-binding error contract: 12 status values
(reference: include/picovoice.h:41-54) mapped 1:1 to typed exceptions, each
carrying a ``message_stack`` of human-readable diagnostic lines (reference:
include/picovoice.h:77-86, binding/python/_koala.py:18-117). In the
reference the stack is produced by the native engine via pv_get_error_stack;
here the engine is in-process, so the stack is recorded on a per-thread
error-stack object that the engine populates as an error propagates outward.
"""

from __future__ import annotations

import enum
import threading
from typing import List, Optional, Sequence


class Status(enum.IntEnum):
    """Engine status codes (parity with reference pv_status_t)."""

    SUCCESS = 0
    OUT_OF_MEMORY = 1
    IO_ERROR = 2
    INVALID_ARGUMENT = 3
    STOP_ITERATION = 4
    KEY_ERROR = 5
    INVALID_STATE = 6
    RUNTIME_ERROR = 7
    ACTIVATION_ERROR = 8
    ACTIVATION_LIMIT_REACHED = 9
    ACTIVATION_THROTTLED = 10
    ACTIVATION_REFUSED = 11


class KoalaError(Exception):
    """Base error. Carries a diagnostic ``message_stack`` like the reference."""

    status: Status = Status.RUNTIME_ERROR

    def __init__(self, message: str = "", message_stack: Optional[Sequence[str]] = None):
        super().__init__(message)
        self._message = message
        self._message_stack: List[str] = list(message_stack or [])

    @property
    def message(self) -> str:
        return self._message

    @property
    def message_stack(self) -> Sequence[str]:
        return self._message_stack

    def __str__(self) -> str:
        if not self._message_stack:
            return self._message
        lines = [self._message + ":"]
        lines += ["  [%d] %s" % (i, m) for i, m in enumerate(self._message_stack)]
        return "\n".join(lines)


class KoalaMemoryError(KoalaError):
    status = Status.OUT_OF_MEMORY


class KoalaIOError(KoalaError):
    status = Status.IO_ERROR


class KoalaInvalidArgumentError(KoalaError):
    status = Status.INVALID_ARGUMENT


class KoalaStopIterationError(KoalaError):
    status = Status.STOP_ITERATION


class KoalaKeyError(KoalaError):
    status = Status.KEY_ERROR


class KoalaInvalidStateError(KoalaError):
    status = Status.INVALID_STATE


class KoalaRuntimeError(KoalaError):
    status = Status.RUNTIME_ERROR


class KoalaActivationError(KoalaError):
    status = Status.ACTIVATION_ERROR


class KoalaActivationLimitError(KoalaError):
    status = Status.ACTIVATION_LIMIT_REACHED


class KoalaActivationThrottledError(KoalaError):
    status = Status.ACTIVATION_THROTTLED


class KoalaActivationRefusedError(KoalaError):
    status = Status.ACTIVATION_REFUSED


_STATUS_TO_ERROR = {
    Status.OUT_OF_MEMORY: KoalaMemoryError,
    Status.IO_ERROR: KoalaIOError,
    Status.INVALID_ARGUMENT: KoalaInvalidArgumentError,
    Status.STOP_ITERATION: KoalaStopIterationError,
    Status.KEY_ERROR: KoalaKeyError,
    Status.INVALID_STATE: KoalaInvalidStateError,
    Status.RUNTIME_ERROR: KoalaRuntimeError,
    Status.ACTIVATION_ERROR: KoalaActivationError,
    Status.ACTIVATION_LIMIT_REACHED: KoalaActivationLimitError,
    Status.ACTIVATION_THROTTLED: KoalaActivationThrottledError,
    Status.ACTIVATION_REFUSED: KoalaActivationRefusedError,
}


def error_for_status(status: Status) -> type:
    """Map a non-SUCCESS status to its exception class."""
    return _STATUS_TO_ERROR.get(Status(status), KoalaRuntimeError)


class ErrorStack:
    """Per-thread diagnostic stack, the in-process analog of
    pv_get_error_stack / pv_free_error_stack (reference picovoice.h:77-86).

    The engine pushes context lines as an error propagates outward; the
    deepest cause is entry [0]. The stack is bounded (the reference's tests
    assert 1..7 entries; see binding/python/test_koala.py:164-185).
    """

    MAX_DEPTH = 7

    def __init__(self) -> None:
        self._local = threading.local()

    def _frames(self) -> List[str]:
        if not hasattr(self._local, "frames"):
            self._local.frames = []
        return self._local.frames

    def clear(self) -> None:
        self._frames().clear()

    def push(self, message: str) -> None:
        frames = self._frames()
        if len(frames) < self.MAX_DEPTH:
            frames.append(message)

    def snapshot(self) -> List[str]:
        return list(self._frames())


# Process-wide error stack used by the engine.
ERROR_STACK = ErrorStack()


def raise_with_stack(error_cls: type, message: str) -> None:
    """Raise ``error_cls`` carrying the current error stack, then clear it."""
    stack = ERROR_STACK.snapshot()
    ERROR_STACK.clear()
    raise error_cls(message, message_stack=stack)


__all__ = [
    "Status",
    "KoalaError",
    "KoalaMemoryError",
    "KoalaIOError",
    "KoalaInvalidArgumentError",
    "KoalaStopIterationError",
    "KoalaKeyError",
    "KoalaInvalidStateError",
    "KoalaRuntimeError",
    "KoalaActivationError",
    "KoalaActivationLimitError",
    "KoalaActivationThrottledError",
    "KoalaActivationRefusedError",
    "error_for_status",
    "ErrorStack",
    "ERROR_STACK",
    "raise_with_stack",
]
