"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one shared library with a plain C
interface, and loaded with ``ctypes``. The build happens at first use, into
``koala_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the sources, so an edited source is rebuilt and an
unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module of the
package, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(verbose: bool = False) -> str:
    """Compile the kernels if needed; return the shared library's path."""
    srcs = _sources()
    digest = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            digest.update(os.path.basename(s).encode() + f.read())
    lib = os.path.join(BUILD_DIR, "libkoala_kernels_%s.so" % digest.hexdigest()[:16])
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for s in srcs:
            if not s.endswith(".cu"):
                continue
            obj = os.path.join(tmp, os.path.basename(s) + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", CSRC, "-c", s, "-o", obj]
            procs.append((s, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs, failed = [], []
        for s, obj, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print("nvcc %s:\n%s" % (os.path.basename(s), out))
            if p.returncode != 0:
                failed.append("%s:\n%s" % (s, out))
            objs.append(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: (argument types, result type). Every pointer and the stream
# are c_void_p so that ctypes never cuts a 64-bit address; a launching entry
# point returns its cudaError_t.
_SIGNATURES = {
    "koala_floor_scan": ([_P, _P, _P, _P, _I, _I, _F, _P], _I),
    "koala_gru_stack": ([_P] * 11 + [_I] * 9 + [_P], _I),
    "koala_gru_smem_bytes": ([_I, _I, _I, _I], ctypes.c_size_t),
    "koala_grid_barriers": ([_P, _I, _I, _I, _P], _I),
    "koala_engine_fused": ([_P], _I),   # pointer to struct FusedArgs (host memory)
    "koala_engine_fused_smem": ([_I, _I], ctypes.c_size_t),
    "koala_empty_launch": ([_P], _I),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def stream_handle(device: torch.device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError("%s: CUDA error %d (launch refused or failed)"
                           % (name, status))


def require_cuda(t: torch.Tensor, name: str, dtype, shape=None,
                 aligned: bool = False) -> None:
    """Validate a tensor handed to a CUDA kernel. ``aligned``: the kernel
    reads it as tensor-core tiles, which need 32-byte aligned addresses."""
    if t.device.type != "cuda":
        raise ValueError("%s: expected a CUDA tensor, got %s" % (name, t.device))
    if t.dtype != dtype:
        raise ValueError("%s: expected %s, got %s" % (name, dtype, t.dtype))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("%s: expected shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s: expected a contiguous tensor" % name)
    if aligned and t.data_ptr() % 32:
        raise ValueError("%s: expected a 32-byte aligned tensor" % name)


__all__ = ["build", "library", "stream_handle", "check", "require_cuda"]
