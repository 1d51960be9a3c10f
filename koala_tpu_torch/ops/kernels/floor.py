"""Minimum-statistics floor tracker: CUDA kernel and its plain version.

``floor_scan`` replaces the JAX package's TPU kernel ``floor_scan_pallas``
(ops/pallas/floor.py:43, kernel body :36):

    floor[t] = min(floor[t-1] + rise, lb[t])    over lb [T, B, nb] f32

On this card the work is bound by bytes (lb read once, floors written once;
one add and one min per element). The kernel (csrc/floor.cu) gives each
(b, band) column one thread that carries the floor in a register over T, so
the recurrence itself moves no bytes. It is bit-identical to
``floor_scan_ref``.
"""

from __future__ import annotations

import torch

from . import _build

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0


def floor_scan_ref(floor0: torch.Tensor, lb: torch.Tensor, rise: float):
    """Plain version: floor0 [B, nb] f32, lb [T, B, nb] f32 ->
    (floor_final [B, nb], floors [T, B, nb]). ``rise`` is added as float32."""
    fl = floor0.float()
    floors = []
    for t in range(lb.shape[0]):
        fl = torch.minimum(fl + rise, lb[t])
        floors.append(fl)
    if not floors:
        return fl, lb.new_zeros((0,) + tuple(floor0.shape))
    return fl, torch.stack(floors)


def floor_scan(floor0: torch.Tensor, lb: torch.Tensor, rise: float):
    """Floor tracker over T frames. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    global launches
    if lb.device.type == "cpu":
        return floor_scan_ref(floor0, lb, rise)
    if lb.dim() != 3:
        raise ValueError("floor_scan: lb must be [T, B, nb], got %s" % (tuple(lb.shape),))
    t_len, b, nb = lb.shape
    _build.require_cuda(lb, "floor_scan lb", torch.float32)
    _build.require_cuda(floor0, "floor_scan floor0", torch.float32, (b, nb))
    lib = _build.library()
    floors = torch.empty_like(lb)
    floor_final = torch.empty_like(floor0)
    status = lib.koala_floor_scan(
        lb.data_ptr(), floor0.data_ptr(), floors.data_ptr(), floor_final.data_ptr(),
        t_len, b * nb, float(rise), _build.stream_handle(lb.device))
    launches += 1
    _build.check(status, "koala_floor_scan")
    return floor_final, floors


__all__ = ["floor_scan", "floor_scan_ref"]
