"""Factory functions: ``create`` and ``create_batch``."""

from __future__ import annotations

from typing import Optional

from .engine.batch import KoalaBatch
from .engine.stream import Koala
from .models.params_io import default_model_path
from .sdk import set_sdk

set_sdk("python")


def create(
        access_key: str,
        model_path: Optional[str] = None,
        device: Optional[str] = None,
        library_path: Optional[str] = None) -> Koala:
    """Create a single-stream Koala engine.

    :param access_key: offline-validated access key (>= 8 base64 chars).
    :param model_path: model parameter file; defaults to the bundled trained
        model (models/koala_params_tpu.pv).
    :param device: ``best | gpu[:i] | cpu[:N]``; defaults to ``best``, the
        CUDA card (an error when there is none).
    :param library_path: accepted for API compatibility; ignored.
    """
    return Koala(
        access_key=access_key,
        model_path=model_path if model_path is not None else default_model_path(),
        device=device if device is not None else "best",
        library_path=library_path)


def create_batch(
        access_key: str,
        batch_size: int,
        model_path: Optional[str] = None,
        device: Optional[str] = None) -> KoalaBatch:
    """Create a pool of ``batch_size`` concurrent streams on one device."""
    return KoalaBatch(
        access_key=access_key,
        model_path=model_path if model_path is not None else default_model_path(),
        batch_size=batch_size,
        device=device if device is not None else "best")


__all__ = ["create", "create_batch"]
