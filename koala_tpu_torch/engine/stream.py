"""Single-stream Koala engine on PyTorch: the reference-contract API surface.

The same surface as the JAX package's ``engine/stream.py``: constructor
signature, ``process``/``reset``/``delete``/``enhance``, state snapshots, the
``sample_rate``/``frame_length``/``delay_sample``/``version`` properties and
the typed errors. ``device`` resolves through ``device.py``: the card unless
the caller asks for the CPU. PCM conversion stays in numpy on the host.
"""

from __future__ import annotations

import os
import re as _re
from typing import Optional, Sequence

import numpy as np
import torch

from .._version import __version__
from ..constants import FRAME_LENGTH, SAMPLE_RATE
from ..device import resolve_device
from ..errors import (
    ERROR_STACK,
    KoalaActivationError,
    KoalaInvalidArgumentError,
    KoalaInvalidStateError,
    raise_with_stack,
)
from ..models import params_io
from ..models.registry import kind_of
from .core import float_to_pcm, make_engine, pcm_to_float

_ACCESS_KEY_RE = _re.compile(r"^[A-Za-z0-9+/=]{8,}$")


def validate_access_key(access_key: str) -> None:
    """Offline AccessKey format check, deterministic across calls."""
    if not isinstance(access_key, str) or len(access_key) == 0:
        ERROR_STACK.push("`access_key` should be a non-empty string")
        raise_with_stack(KoalaInvalidArgumentError, "Invalid access key")
    if _ACCESS_KEY_RE.match(access_key) is None:
        ERROR_STACK.push("AccessKey format is invalid: expected >= 8 base64 characters")
        ERROR_STACK.push("Failed to validate AccessKey")
        raise_with_stack(KoalaActivationError, "Initialization failed")
    from ..sdk import check_revocation

    check_revocation(access_key)


def check_model_path(model_path) -> None:
    if not isinstance(model_path, str) or not os.path.exists(model_path):
        ERROR_STACK.push("could not find model file at `%s`" % model_path)
        raise_with_stack(KoalaInvalidArgumentError, "Initialization failed")


def load_model(model_path, device):
    """Model file -> (engine, parameter module on device)."""
    tree, config = params_io.load_params(model_path)
    kind = kind_of(config)
    engine = make_engine(kind, config)
    return engine, params_io.params_from_numpy(tree, device, kind, config)


def snapshot(state) -> dict:
    """Engine state -> flat {"model/h": numpy, ...}, the JAX package's
    snapshot layout, so a snapshot loads in either package."""
    return {k: np.asarray(v) for k, v in params_io._flatten(state).items()}


def restore(engine, batch_shape, snap: dict, device):
    """A ``snapshot`` -> engine state on ``device``, checked against the
    engine's fresh state layout."""
    expected = params_io._flatten(engine.init_state(batch_shape, device))
    if set(snap.keys()) != set(expected.keys()):
        ERROR_STACK.push("state snapshot keys do not match engine state")
        raise_with_stack(KoalaInvalidArgumentError, "Invalid state snapshot")
    for k, v in expected.items():
        if tuple(np.shape(snap[k])) != tuple(np.shape(v)):
            ERROR_STACK.push("state leaf `%s` has shape %s, expected %s"
                             % (k, np.shape(snap[k]), np.shape(v)))
            raise_with_stack(KoalaInvalidArgumentError, "Invalid state snapshot")
    tree = params_io._unflatten({k: np.asarray(v) for k, v in snap.items()})
    return params_io.state_from_numpy(tree, device)


class Koala:
    """Streaming noise suppressor over one audio stream: consecutive
    256-sample frames of 16 kHz mono int16 in, enhanced frames of the same
    size out, delayed by ``delay_sample`` samples."""

    def __init__(
            self,
            access_key: str,
            model_path: str,
            device: str = "best",
            library_path: Optional[str] = None) -> None:
        validate_access_key(access_key)
        check_model_path(model_path)
        self._device = resolve_device(device)
        self._engine, self._params = load_model(model_path, self._device)
        self._state = self._engine.init_state((), self._device)
        self._handle = object()   # sentinel; nulled by delete()

    def _check_handle(self) -> None:
        if getattr(self, "_handle", None) is None:
            ERROR_STACK.push("Koala object has been deleted or is invalid")
            ERROR_STACK.push("Processing failed on invalid handle")
            raise_with_stack(KoalaInvalidStateError, "Invalid Koala state")

    @property
    def device(self) -> torch.device:
        return self._device

    @torch.inference_mode()
    def process(self, pcm: Sequence[int]) -> Sequence[int]:
        """Process one 256-sample frame; returns the delayed enhanced frame."""
        self._check_handle()
        if len(pcm) != FRAME_LENGTH:
            raise KoalaInvalidArgumentError(
                "Length of input frame %d does not match required frame length %d"
                % (len(pcm), FRAME_LENGTH))
        hop = torch.as_tensor(pcm_to_float(pcm), device=self._device)
        self._state, out = self._engine.step(self._params, self._state, hop)
        return float_to_pcm(out).tolist()

    def reset(self) -> None:
        """Restore fresh-stream state; later output is bit-identical to a
        newly created object's."""
        self._check_handle()
        self._state = self._engine.init_state((), self._device)

    def delete(self) -> None:
        """Release resources; further calls raise KoalaInvalidStateError."""
        self._handle = None
        self._state = None
        self._params = None

    @torch.inference_mode()
    def enhance(self, pcm: Sequence[int]) -> np.ndarray:
        """Enhance a whole utterance with delay compensation: pad, stream in
        one sequence call, trim ``delay_sample`` from the head so the output
        aligns 1:1 with the input."""
        self._check_handle()
        pcm = np.asarray(pcm)
        n = pcm.shape[-1]
        delay = self._engine.delay_sample
        t = -(-(n + delay) // FRAME_LENGTH)
        padded = np.zeros((t * FRAME_LENGTH,), np.float32)
        padded[:n] = np.asarray(pcm, np.float32)
        hops = torch.as_tensor(pcm_to_float(padded).reshape(t, FRAME_LENGTH),
                               device=self._device)
        self._state, out = self._engine.sequence(self._params, self._state, hops)
        flat = out.reshape(-1).cpu().numpy()
        return float_to_pcm(flat[delay:delay + n])

    def save_state(self) -> dict:
        """Snapshot the streaming state as host numpy arrays (same keys as
        the JAX package's snapshot)."""
        self._check_handle()
        return snapshot(self._state)

    def load_state(self, snap: dict) -> None:
        """Restore a ``save_state`` snapshot (from either package)."""
        self._check_handle()
        self._state = restore(self._engine, (), snap, self._device)

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    @property
    def frame_length(self) -> int:
        return FRAME_LENGTH

    @property
    def delay_sample(self) -> int:
        return self._engine.delay_sample

    @property
    def version(self) -> str:
        return __version__


__all__ = ["Koala", "validate_access_key"]
