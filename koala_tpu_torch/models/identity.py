"""Identity (unit-mask) model: passes the spectrum through unchanged.

A diagnostic model kind that isolates the engine's STFT/OLA machinery: with
a unit mask the engine reproduces its input exactly, delayed by one hop.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

DEFAULT_CONFIG = {"kind": "identity"}


class Identity(nn.Module):
    """Parameters of the identity model: one unused placeholder, as in the
    JAX package's tree ({"empty": [0.0]})."""

    def __init__(self, tree=None):
        super().__init__()
        empty = np.zeros((1,), np.float32) if tree is None else tree["empty"]
        self.empty = nn.Parameter(torch.tensor(np.asarray(empty, np.float32)),
                                  requires_grad=False)


def init_state(batch_shape: Tuple[int, ...], config: Dict[str, Any], device):
    return torch.zeros(tuple(batch_shape) + (1,), device=torch.device(device))


def step(params, state, re, im, config: Dict[str, Any] = None):
    return state, torch.ones_like(re)


def apply_sequence(params, state, re, im, config: Dict[str, Any] = None):
    return state, torch.ones_like(re)


__all__ = ["DEFAULT_CONFIG", "Identity", "init_state", "step", "apply_sequence"]
