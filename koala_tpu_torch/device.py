"""Device-string grammar resolved to ``torch.device``.

Same grammar as the JAX package (``best | cpu[:NUM_THREADS] | gpu[:GPU_INDEX]
| tpu[:INDEX]``), resolved for PyTorch:

- ``best`` and ``gpu[:i]`` mean the CUDA card ``cuda:i``. Without a card they
  raise ``KoalaInvalidArgumentError``: the port never carries on silently on
  the CPU when a card was asked for.
- ``cpu[:N]`` is the CPU, asked for explicitly. ``N`` is accepted for
  compatibility and does not change the thread count.
- ``tpu[:i]`` raises: this package has no TPU backend.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from .errors import ERROR_STACK, KoalaInvalidArgumentError, raise_with_stack

_DEVICE_RE = re.compile(r"^(best|cpu|gpu|tpu)(:(\d+))?$")


class DeviceSpec:
    """Parsed device request: kind + optional index/threads."""

    def __init__(self, kind: str, index: Optional[int] = None):
        self.kind = kind
        self.index = index

    def __repr__(self) -> str:
        return f"DeviceSpec({self.kind!r}, {self.index!r})"


def parse_device(device: str) -> DeviceSpec:
    """Parse a device string; raises KoalaInvalidArgumentError on bad grammar."""
    if not isinstance(device, str) or len(device) == 0:
        ERROR_STACK.push("`device` should be a non-empty string")
        raise_with_stack(KoalaInvalidArgumentError, "Invalid device argument")
    m = _DEVICE_RE.match(device.strip().lower())
    if m is None:
        ERROR_STACK.push(
            "device must match `best|cpu[:NUM_THREADS]|gpu[:GPU_INDEX]`, got `%s`" % device)
        raise_with_stack(KoalaInvalidArgumentError, "Invalid device argument")
    kind = m.group(1)
    index = int(m.group(3)) if m.group(3) is not None else None
    return DeviceSpec(kind, index)


def resolve_torch_device(spec: DeviceSpec) -> torch.device:
    """Resolve a DeviceSpec to a concrete ``torch.device``."""
    if spec.kind == "cpu":
        return torch.device("cpu")
    if spec.kind == "tpu":
        ERROR_STACK.push("this package runs on CUDA cards; `tpu` is not available")
        raise_with_stack(KoalaInvalidArgumentError, "Invalid device argument")
    if not torch.cuda.is_available():
        ERROR_STACK.push("no CUDA card available for device `%s`; pass `cpu` "
                         "to run on the CPU" % spec.kind)
        raise_with_stack(KoalaInvalidArgumentError, "Invalid device argument")
    idx = spec.index or 0
    count = torch.cuda.device_count()
    if idx >= count:
        ERROR_STACK.push("device index %d out of range for gpu (%d available)"
                         % (idx, count))
        raise_with_stack(KoalaInvalidArgumentError, "Invalid device argument")
    return torch.device("cuda", idx)


def resolve_device(device: str) -> torch.device:
    """Parse and resolve a device string in one call."""
    return resolve_torch_device(parse_device(device))


def available_devices() -> List[str]:
    """List device strings accepted by create()."""
    out: List[str] = ["best"] if torch.cuda.is_available() else []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        out.append("gpu:%d - %s" % (i, torch.cuda.get_device_name(i)))
    n = os.cpu_count() or 1
    out.append("cpu:[0-%d] - CPU (thread count accepted for compatibility)" % n)
    return out


__all__ = ["DeviceSpec", "parse_device", "resolve_torch_device",
           "resolve_device", "available_devices"]
