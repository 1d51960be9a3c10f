"""ctypes binding to the native host runtime (``native/koala_host.cpp``).

The native library is the host data plane of the serving path: per-stream
SPSC ring buffers, batched frame gather, PCM conversion and metering (see
``include/koala_tpu_host.h``). This module exposes it as ``StreamPool``, the
surface the JAX package's ``hostlib.py`` has, over the same unchanged
sources.

The library is compiled with ``g++`` at first use into
``koala_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the sources and flags, as the CUDA kernels are
(``ops/kernels/_build.py``). Nothing is written under ``native/``. A failed
build raises ``KoalaRuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Tuple

import numpy as np

from .errors import ERROR_STACK, KoalaRuntimeError, raise_with_stack

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG)
SOURCES = (os.path.join(_REPO_ROOT, "native", "koala_host.cpp"),
           os.path.join(_REPO_ROOT, "include", "koala_tpu_host.h"))
BUILD_DIR = os.path.join(_PKG, "_build")
# native/Makefile's flags, so that both packages run the same machine code
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the library for the current sources and flags is built."""
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for s in SOURCES:
        with open(s, "rb") as f:
            digest.update(os.path.basename(s).encode() + f.read())
    return os.path.join(BUILD_DIR, "libkoala_host_%s.so" % digest.hexdigest()[:16])


def build() -> str:
    """Compile the library if needed; return its path. The compiler writes
    into a temporary directory beside the result, which is then renamed into
    place, so concurrent builds never load a half-written file."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    cxx = shutil.which("g++") or "g++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        try:
            subprocess.run([cxx, *CXXFLAGS, "-o", out, SOURCES[0]], check=True,
                           capture_output=True, text=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            ERROR_STACK.push("failed to build the native host library: %s" % detail[:500])
            raise_with_stack(KoalaRuntimeError, "Native build failed")
        os.replace(out, lib)
    return lib


_SIGNATURES = {
    "kt_pool_create": ([ctypes.c_int32] * 3, ctypes.c_void_p),
    "kt_pool_delete": ([ctypes.c_void_p], None),
    "kt_pool_push": ([ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int16),
                      ctypes.c_int32], ctypes.c_int),
    "kt_pool_frames_ready": ([ctypes.c_void_p, ctypes.c_int32], ctypes.c_int32),
    "kt_pool_gather": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                        ctypes.POINTER(ctypes.c_uint8)], ctypes.c_int32),
    "kt_pool_gather_f32": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_uint8)], ctypes.c_int32),
    "kt_pool_gather_chunk": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                              ctypes.POINTER(ctypes.c_int32), ctypes.c_int32], ctypes.c_int32),
    "kt_pool_push_rows": ([ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                           ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int32),
                           ctypes.c_int32], ctypes.c_int32),
    "kt_pool_push_rows_f32": ([ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                               ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int32], ctypes.c_int32),
    "kt_pool_pull": ([ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int16),
                      ctypes.c_int32], ctypes.c_int32),
    "kt_pool_reset_stream": ([ctypes.c_void_p, ctypes.c_int32], None),
    "kt_pool_dropped_samples": ([ctypes.c_void_p], ctypes.c_int64),
    "kt_pcm_to_f32": ([ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
                       ctypes.c_int64], None),
    "kt_f32_to_pcm": ([ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
                       ctypes.c_int64], None),
    "kt_rms": ([ctypes.POINTER(ctypes.c_int16), ctypes.c_int64], ctypes.c_float),
    "kt_peak": ([ctypes.POINTER(ctypes.c_int16), ctypes.c_int64], ctypes.c_float),
    "kt_host_version": ([], ctypes.c_char_p),
}


def load_hostlib() -> ctypes.CDLL:
    """Load (building at first use) the native host library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def _i16ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class StreamPool:
    """Pool of per-stream ring buffers feeding batched device steps."""

    def __init__(self, num_streams: int, frame_length: int = 256,
                 capacity_frames: int = 64):
        self._lib = load_hostlib()
        self._handle = self._lib.kt_pool_create(num_streams, frame_length,
                                                capacity_frames)
        if not self._handle:
            raise_with_stack(KoalaRuntimeError, "kt_pool_create failed")
        self.num_streams = num_streams
        self.frame_length = frame_length
        self._batch = np.zeros((num_streams, frame_length), np.int16)
        self._active = np.zeros((num_streams,), np.uint8)
        self._chunk_bufs = {}   # max_frames -> ([B, k, frame] int16, [B] int32)

    def push(self, stream: int, samples: np.ndarray) -> bool:
        """Append int16 samples to a stream; False if the ring overflowed."""
        samples = np.ascontiguousarray(samples, np.int16)
        status = self._lib.kt_pool_push(self._handle, stream, _i16ptr(samples),
                                        len(samples))
        return status == 0

    def frames_ready(self, stream: int) -> int:
        return self._lib.kt_pool_frames_ready(self._handle, stream)

    def gather(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (batch [B, frame] int16, active [B] bool, n_active). Rows of
        inactive streams are zero."""
        n = self._lib.kt_pool_gather(
            self._handle, _i16ptr(self._batch),
            self._active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return self._batch, self._active.astype(bool), int(n)

    def gather_chunk(self, max_frames: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (batch [B, k, frame] int16, counts [B] int32, total_frames).
        Pops up to ``max_frames`` backlogged frames per stream; frames past a
        stream's backlog are zero. The returned buffers are reused by the
        next call with the same ``max_frames``."""
        if max_frames not in self._chunk_bufs:
            self._chunk_bufs[max_frames] = (
                np.zeros((self.num_streams, max_frames, self.frame_length), np.int16),
                np.zeros((self.num_streams,), np.int32))
        batch, counts = self._chunk_bufs[max_frames]
        total = self._lib.kt_pool_gather_chunk(self._handle, _i16ptr(batch),
                                               _i32ptr(counts), max_frames)
        return batch, counts, int(total)

    def push_rows(self, rows: np.ndarray, counts: np.ndarray,
                  first_stream: int = 0) -> int:
        """Batched push: append counts[i] frames from rows[i] ([n, k, frame]
        int16) to streams first_stream + i in one native call. Returns the
        frames appended."""
        rows = np.ascontiguousarray(rows, np.int16)
        if rows.ndim == 2:                      # [n, frame]: one frame a row
            rows = rows[:, None, :]
        counts = np.ascontiguousarray(counts, np.int32)
        return int(self._lib.kt_pool_push_rows(self._handle, first_stream, rows.shape[0],
                                               _i16ptr(rows), _i32ptr(counts),
                                               rows.shape[1]))

    def push_rows_f32(self, rows: np.ndarray, counts: np.ndarray,
                      first_stream: int = 0) -> int:
        """As ``push_rows``, with float32 rows at fullscale 1.0, converted to
        int16 inside the native call."""
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.ndim == 2:
            rows = rows[:, None, :]
        counts = np.ascontiguousarray(counts, np.int32)
        return int(self._lib.kt_pool_push_rows_f32(self._handle, first_stream,
                                                   rows.shape[0], _f32ptr(rows),
                                                   _i32ptr(counts), rows.shape[1]))

    def pull(self, stream: int, max_samples: int) -> np.ndarray:
        """Pop up to ``max_samples`` buffered samples from one stream."""
        out = np.empty((max_samples,), np.int16)
        n = self._lib.kt_pool_pull(self._handle, stream, _i16ptr(out), max_samples)
        return out[:max(n, 0)]

    def reset_stream(self, stream: int) -> None:
        self._lib.kt_pool_reset_stream(self._handle, stream)

    @property
    def dropped_samples(self) -> int:
        return int(self._lib.kt_pool_dropped_samples(self._handle))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.kt_pool_delete(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def pcm_to_f32(pcm: np.ndarray) -> np.ndarray:
    lib = load_hostlib()
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(pcm.shape, np.float32)
    lib.kt_pcm_to_f32(_i16ptr(pcm), _f32ptr(out), pcm.size)
    return out


def f32_to_pcm(x: np.ndarray) -> np.ndarray:
    lib = load_hostlib()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    lib.kt_f32_to_pcm(_f32ptr(x), _i16ptr(out), x.size)
    return out


def rms(pcm: np.ndarray) -> float:
    lib = load_hostlib()
    pcm = np.ascontiguousarray(pcm, np.int16)
    return float(lib.kt_rms(_i16ptr(pcm), pcm.size))


__all__ = ["StreamPool", "load_hostlib", "build", "library_path", "pcm_to_f32",
           "f32_to_pcm", "rms"]
