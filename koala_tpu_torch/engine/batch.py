"""Batched stream pool on PyTorch: B concurrent streams on one device.

The same surface as the JAX package's ``engine/batch.py``. B streams advance
in lockstep as [B, 256] frames or [B, T, 256] chunks, with all recurrent
state resident on the device between calls. ``process_chunk`` runs the
sequence engine (the floor and GRU kernels on a card); ``enhance`` runs
``sequence_fast`` (the fused engine kernel on a card). Per-stream ``reset``
is a masked replacement of state leaves, whose batch axis leads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import FRAME_LENGTH, SAMPLE_RATE
from ..device import resolve_device
from ..errors import (
    ERROR_STACK,
    KoalaInvalidArgumentError,
    KoalaInvalidStateError,
    raise_with_stack,
)
from .core import _tree_map, float_to_pcm, pcm_to_float
from .stream import check_model_path, load_model, restore, snapshot, validate_access_key


def masked_reset(state, fresh_state, reset_mask: torch.Tensor):
    """Replace state leaves with fresh values where reset_mask[b] is True.
    Every leaf is [*batch, ...]; the [*batch] mask broadcasts from the left."""
    batch_ndim = reset_mask.dim()

    def leaf_reset(cur, new):
        m = reset_mask.reshape(reset_mask.shape + (1,) * (cur.dim() - batch_ndim))
        return torch.where(m, new, cur)

    return _tree_map(leaf_reset, state, fresh_state)


class KoalaBatch:
    """Pool of ``batch_size`` concurrent noise-suppression streams."""

    def __init__(
            self,
            access_key: str,
            model_path: str,
            batch_size: int,
            device: str = "best",
            library_path: Optional[str] = None) -> None:
        validate_access_key(access_key)
        if not isinstance(batch_size, int) or batch_size <= 0:
            ERROR_STACK.push("`batch_size` must be a positive integer")
            raise_with_stack(KoalaInvalidArgumentError, "Initialization failed")
        check_model_path(model_path)
        self._batch_size = batch_size
        self._device = resolve_device(device)
        self._engine, self._params = load_model(model_path, self._device)
        self._state = self._engine.init_state((batch_size,), self._device)
        self._handle = object()

    def _check_handle(self) -> None:
        if getattr(self, "_handle", None) is None:
            ERROR_STACK.push("KoalaBatch object has been deleted or is invalid")
            ERROR_STACK.push("Processing failed on invalid handle")
            raise_with_stack(KoalaInvalidStateError, "Invalid Koala state")

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    @property
    def frame_length(self) -> int:
        return FRAME_LENGTH

    @property
    def delay_sample(self) -> int:
        return self._engine.delay_sample

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(pcm_to_float(x), device=self._device)

    @torch.inference_mode()
    def process(self, frames) -> np.ndarray:
        """[B, 256] int16 frames -> [B, 256] enhanced int16 (delayed)."""
        self._check_handle()
        frames = np.asarray(frames)
        if frames.shape != (self._batch_size, FRAME_LENGTH):
            raise KoalaInvalidArgumentError(
                "Expected input of shape (%d, %d), got %s"
                % (self._batch_size, FRAME_LENGTH, frames.shape))
        self._state, out = self._engine.step(self._params, self._state,
                                             self._to_device(frames))
        return float_to_pcm(out)

    @torch.inference_mode()
    def process_chunk(self, pcm) -> np.ndarray:
        """[B, T*256] int16 -> [B, T*256] enhanced int16 (delayed stream);
        the same result as T successive ``process`` calls, bit for bit on a
        card. On the CPU, whose vectorised sigmoid and gelu round a tensor's
        last few elements as their scalar forms do, within an LSB."""
        self._check_handle()
        pcm = np.asarray(pcm)
        if pcm.ndim != 2 or pcm.shape[0] != self._batch_size \
                or pcm.shape[1] % FRAME_LENGTH != 0:
            raise KoalaInvalidArgumentError(
                "Expected input of shape (%d, k*%d), got %s"
                % (self._batch_size, FRAME_LENGTH, pcm.shape))
        hops = self._to_device(pcm).reshape(self._batch_size, -1, FRAME_LENGTH)
        self._state, out = self._engine.sequence(self._params, self._state, hops)
        return float_to_pcm(out.reshape(self._batch_size, -1))

    @torch.inference_mode()
    def enhance(self, pcm) -> np.ndarray:
        """Delay-compensated batch enhancement: [B, N] int16 -> [B, N] int16
        aligned 1:1 with the input, through the fused engine on a card."""
        self._check_handle()
        pcm = np.asarray(pcm)
        if pcm.ndim != 2 or pcm.shape[0] != self._batch_size:
            raise KoalaInvalidArgumentError(
                "Expected input of shape (%d, N), got %s" % (self._batch_size, pcm.shape))
        n = pcm.shape[1]
        delay = self._engine.delay_sample
        t = -(-(n + delay) // FRAME_LENGTH)
        padded = np.zeros((self._batch_size, t * FRAME_LENGTH), np.float32)
        padded[:, :n] = pcm.astype(np.float32)
        hops = self._to_device(padded).reshape(self._batch_size, t, FRAME_LENGTH)
        self._state, out = self._engine.sequence_fast(self._params, self._state, hops)
        flat = out.reshape(self._batch_size, -1).cpu().numpy()
        return float_to_pcm(flat[:, delay:delay + n])

    def reset(self, streams: Optional[Sequence[int]] = None) -> None:
        """Reset all streams, or only the given stream indices."""
        self._check_handle()
        if streams is None:
            mask = np.ones((self._batch_size,), bool)
        else:
            mask = np.zeros((self._batch_size,), bool)
            for s in streams:
                if not 0 <= s < self._batch_size:
                    raise KoalaInvalidArgumentError(
                        "stream index %d out of range [0, %d)" % (s, self._batch_size))
                mask[s] = True
        fresh = self._engine.init_state((self._batch_size,), self._device)
        self._state = masked_reset(self._state, fresh,
                                   torch.as_tensor(mask, device=self._device))

    def save_state(self) -> dict:
        """Snapshot all streams' state as host numpy arrays."""
        self._check_handle()
        return snapshot(self._state)

    def load_state(self, snap: dict) -> None:
        self._check_handle()
        self._state = restore(self._engine, (self._batch_size,), snap, self._device)

    def delete(self) -> None:
        self._handle = None
        self._state = None
        self._params = None


__all__ = ["KoalaBatch", "masked_reset"]
