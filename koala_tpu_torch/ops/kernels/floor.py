"""Minimum-statistics floor tracker: CUDA kernel and its plain version.

``floor_scan`` replaces the JAX package's TPU kernel ``floor_scan_pallas``
(ops/pallas/floor.py:44, kernel body :36):

    floor[t] = min(floor[t-1] + rise, lb[t])    over lb [T, B, nb] f32

On this card the work is bound by bytes (lb read once, floors written once;
one add and one min per element); what a column-per-thread loop pays instead
is the latency of T loads in a row. The kernel (csrc/floor_scan.cuh, which
the fused engine's floor stage shares) gives a block 32 neighbouring
(b, band) columns, brings lb into shared memory slab by slab with every copy
of a slab in flight at once and the next slab on its way, and scans it
there, a lane per column with the carried floor in a register. The
recurrence stays sequential in T with its arithmetic untouched, so the
result is bit-identical to ``floor_scan_ref``.

``floor_scan_trainable`` is the differentiable form: the same forward, and
as backward the analytic reverse pass of the JAX package's
``floor_scan_trainable`` (ops/pallas/floor.py:105-122), which is plain code
there too, not a kernel.
"""

from __future__ import annotations

import torch

from ... import profiling
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


def bound(t_len: int, b: int, nb: int):
    """Least time (ms) of the floor tracker over lb [t_len, b, nb] f32 on an
    H100 (``profiling.bound``): lb read and the floors written once, the
    state both ways; an add and a min an element."""
    return profiling.bound((2 * t_len * b * nb + 2 * b * nb) * 4, 0, 2 * t_len * b * nb)


def empty_launch(device) -> None:
    """Launch a kernel that does nothing: what any launch costs at least,
    timed beside the floor kernel, whose bound lies below it. Not a launch of
    the floor kernel."""
    _build.check(_build.library().koala_empty_launch(_build.stream_handle(device)),
                 "koala_empty_launch")


def floor_scan_backward(floor0, lb, floors, rise: float, ct_final, ct_floors):
    """Reverse pass of the tracker: the recurrence is piecewise linear, so it
    needs only which branch of the min each step took, read off the stored
    floors. A tie goes to the first argument (the rise branch), as the JAX
    package's backward has it. -> (dfloor0 [B, nb], dlb [T, B, nb])."""
    f_prev = torch.cat([floor0.unsqueeze(0), floors[:-1]], dim=0)
    took_rise = ((f_prev + rise) <= lb).to(ct_floors.dtype)
    g = ct_floors.clone()
    if g.shape[0]:
        g[-1] += ct_final
    a = torch.zeros_like(floor0)
    dlb = torch.empty_like(lb)
    for t in range(lb.shape[0] - 1, -1, -1):
        tot = g[t] + a
        a = tot * took_rise[t]
        dlb[t] = tot * (1.0 - took_rise[t])
    return (a if lb.shape[0] else ct_final), dlb


class _FloorScanTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, floor0, lb, rise):
        floor_final, floors = floor_scan(floor0, lb, rise)
        ctx.save_for_backward(floor0, lb, floors)
        ctx.rise = rise
        return floor_final, floors

    @staticmethod
    def backward(ctx, ct_final, ct_floors):
        floor0, lb, floors = ctx.saved_tensors
        dfloor0, dlb = floor_scan_backward(floor0, lb, floors, ctx.rise, ct_final, ct_floors)
        return dfloor0, dlb, None


def floor_scan_trainable(floor0: torch.Tensor, lb: torch.Tensor, rise: float):
    """Differentiable ``floor_scan``: forward is the kernel (the plain version
    for CPU tensors), backward ``floor_scan_backward``. ``rise`` takes no
    gradient."""
    return _FloorScanTrainable.apply(floor0, lb, rise)


__all__ = ["floor_scan", "floor_scan_ref", "floor_scan_trainable", "floor_scan_backward",
           "empty_launch", "bound"]
