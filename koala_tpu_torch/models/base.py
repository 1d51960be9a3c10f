"""What the parameter modules of every model kind share: the frozen
parameter, the base module with its cache of derived tensors, the module of
a kind without weights, and a cache of fixed arrays on a device."""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn


def param(a) -> nn.Parameter:
    """A tensor or array as a frozen float32 parameter (a copy)."""
    if isinstance(a, torch.Tensor):
        return nn.Parameter(a.detach().float().clone(), requires_grad=False)
    return nn.Parameter(torch.tensor(np.asarray(a, np.float32)), requires_grad=False)


class ParamModule(nn.Module):
    """A model's parameters. ``state_dict`` keys map one to one onto the
    ``.pv`` flat names (``gru/0/wx`` -> ``gru.0.wx``)."""

    def __init__(self):
        super().__init__()
        self._derived: Dict[str, Tuple[Any, Any]] = {}

    def derived(self, name: str, build):
        """A tensor derived from the weights (a bf16 copy, a stacked or padded
        layout, a kernel's operand set), built once and rebuilt when a weight
        changes or moves."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        hit = self._derived.get(name)
        if hit is None or hit[0] != key:
            # a plain tensor without a graph: usable in a graph recorded later
            # (inference_mode(False) alone would switch grad mode on)
            with torch.inference_mode(False), torch.no_grad():
                hit = (key, build())
            self._derived[name] = hit
        return hit[1]

    def num_params(self) -> int:
        """The number of parameters of the model (every weight and bias)."""
        return sum(p.numel() for p in self.parameters())


num_params = ParamModule.num_params


class Placeholder(ParamModule):
    """The parameters of a model without weights: one unused leaf, as in the
    JAX package's tree ({"empty": [0.0]}), so that save, load and the
    engine's parameter plumbing stay uniform across model kinds."""

    def __init__(self, tree=None):
        super().__init__()
        self.empty = param(np.zeros((1,), np.float32) if tree is None else tree["empty"])


@functools.lru_cache(maxsize=32)
def constant_on(build, device: torch.device, *args) -> torch.Tensor:
    """``build(*args)``, a fixed array, as a tensor on ``device``, made once.
    Made outside inference mode, so that a constant first asked for by a
    serving call can enter a graph that a trainer records later."""
    with torch.inference_mode(False):
        return torch.as_tensor(build(*args), device=device)


__all__ = ["param", "ParamModule", "Placeholder", "num_params", "constant_on"]
