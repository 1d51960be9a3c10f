"""Identity (unit-mask) model: passes the spectrum through unchanged.

A diagnostic model kind that isolates the engine's STFT/OLA machinery: with
a unit mask the engine reproduces its input exactly, delayed by one hop.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .base import Placeholder

DEFAULT_CONFIG = {"kind": "identity"}
Identity = Params = Placeholder     # one unused placeholder leaf


def init_params(key=None, config: Dict[str, Any] = None) -> Identity:
    """The identity model's parameters (its one placeholder); ``key`` and
    ``config`` are taken for the JAX package's signature and not used."""
    return Identity()


def init_state(batch_shape: Tuple[int, ...], config: Dict[str, Any], device):
    return torch.zeros(tuple(batch_shape) + (1,), device=torch.device(device))


def step(params, state, re, im, config: Dict[str, Any] = None):
    """A unit mask of the spectrum's shape: one frame [*, K] or T [*, T, K]."""
    return state, torch.ones_like(re)


apply_sequence = step


__all__ = ["DEFAULT_CONFIG", "Identity", "Params", "init_params", "init_state", "step",
           "apply_sequence"]
