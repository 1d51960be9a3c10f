"""koala_tpu_torch - the Koala-class streaming noise suppressor on PyTorch
and CUDA (NVIDIA Hopper).

A port of the JAX package beside it, which stays the reference: the same
``.pv`` model files, the same 16 kHz / 256-sample frame contract with a
256-sample delay, the same ``create`` / ``Koala`` / ``KoalaBatch`` surface and
the same streaming-state layout. The TPU kernels of its main path are
hand-written CUDA kernels here (``csrc/``), built with ``nvcc`` at first use.
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from ._version import __version__
from .constants import DELAY_SAMPLE, FRAME_LENGTH, SAMPLE_RATE
from .device import available_devices
from .engine import Koala, KoalaBatch
from .errors import (
    KoalaActivationError,
    KoalaActivationLimitError,
    KoalaActivationRefusedError,
    KoalaActivationThrottledError,
    KoalaError,
    KoalaIOError,
    KoalaInvalidArgumentError,
    KoalaInvalidStateError,
    KoalaKeyError,
    KoalaMemoryError,
    KoalaRuntimeError,
    KoalaStopIterationError,
    Status,
)
from .factory import create, create_batch
from .sdk import get_sdk, set_sdk

__all__ = [
    "__version__",
    "create",
    "create_batch",
    "available_devices",
    "set_sdk",
    "get_sdk",
    "Koala",
    "KoalaBatch",
    "SAMPLE_RATE",
    "FRAME_LENGTH",
    "DELAY_SAMPLE",
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
]
