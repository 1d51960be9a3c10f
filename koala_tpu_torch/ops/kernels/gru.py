"""Fused GRU-stack recurrence: CUDA kernel and its plain version.

``gru_stack`` replaces the JAX package's TPU kernel ``gru_stack_pallas``
(ops/pallas/gru.py:103, kernel body :60), forward only. Per step
and layer, with x_0 = x[t] (bf16):

    xp = bf16(x_l) @ wx_l + bx_l,  hp = bf16(h_l) @ wh_l + bh_l   (f32 sums)
    z, r, n gates as _gru_gates (gru.py:50-57), h_l' = (1-z) n + z h_l
    x_{l+1} = x_l + h_l' in f32, re-cast to bf16;  y[t] = x_L

On this card the least time is set by the bf16 products (operations); what
limits this first design is that each block reads the 2L weight matrices
(3.5 MB bf16 at H = 384, L = 2) from L2 once per step. The kernel (csrc/gru.cu) gives
one block 16 stream rows for the whole T x L loop, keeps their hidden state
in shared memory and runs the products on the tensor cores with the weights
read from L2 (see the source's note).

Weights come stacked: wx, wh [L, H, 3H] bf16 and bx, bh [L, 3H] f32.
"""

from __future__ import annotations

import torch

from . import _build

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0


def _gates(h, hp, xp):
    """_gru_gates in f32: h [B,H], hp/xp [B,3H] -> new h [B,H]."""
    hz, hr, hn = hp.chunk(3, dim=-1)
    xz, xr, xn = xp.chunk(3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def layers_step(h_prev, x_bf, wx, bx, wh, bh):
    """One step through the stack, the kernel's numerics: bf16 product
    inputs, f32 sums, gates and state, bf16 residual stream.
    h_prev [L,B,H] f32, x_bf [B,H] bf16 -> (h_new [L,B,H] f32, y_t [B,H] bf16)."""
    x_f = x_bf.float()
    xb = x_bf
    new_h = []
    for l in range(h_prev.shape[0]):
        xp = xb.float() @ wx[l].float() + bx[l]
        hp = h_prev[l].bfloat16().float() @ wh[l].float() + bh[l]
        h_new = _gates(h_prev[l], hp, xp)
        new_h.append(h_new)
        x_f = x_f + h_new
        xb = x_f.bfloat16()
    return torch.stack(new_h), xb


def gru_stack_ref(h0, x, wx, bx, wh, bh):
    """Plain version: h0 [L,B,H] f32, x [T,B,H] -> (y [T,B,H] bf16,
    h_final [L,B,H] f32)."""
    h = h0.float()
    wx, wh = wx.bfloat16(), wh.bfloat16()
    ys = []
    for t in range(x.shape[0]):
        h, y_t = layers_step(h, x[t].bfloat16(), wx, bx.float(), wh, bh.float())
        ys.append(y_t)
    y = torch.stack(ys) if ys else x.bfloat16()
    return y, h


def gru_stack(h0, x, wx, bx, wh, bh):
    """Run the L-layer GRU recurrence over T steps. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    global launches
    if x.device.type == "cpu":
        return gru_stack_ref(h0, x, wx, bx, wh, bh)
    if x.dim() != 3 or h0.dim() != 3:
        raise ValueError("gru_stack: x must be [T,B,H] and h0 [L,B,H]")
    t_len, b, hidden = x.shape
    layers = h0.shape[0]
    if hidden % 16:
        raise ValueError("gru_stack: hidden %d is not a multiple of 16" % hidden)
    _build.require_cuda(x, "gru_stack x", torch.bfloat16)
    _build.require_cuda(h0, "gru_stack h0", torch.float32, (layers, b, hidden))
    for name, w in (("wx", wx), ("wh", wh)):
        _build.require_cuda(w, "gru_stack " + name, torch.bfloat16,
                            (layers, hidden, 3 * hidden), aligned=True)
    for name, v in (("bx", bx), ("bh", bh)):
        _build.require_cuda(v, "gru_stack " + name, torch.float32, (layers, 3 * hidden))
    lib = _build.library()
    y = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    status = lib.koala_gru_stack(
        x.data_ptr(), h0.data_ptr(), wx.data_ptr(), bx.data_ptr(), wh.data_ptr(),
        bh.data_ptr(), y.data_ptr(), h_final.data_ptr(), t_len, b, hidden, layers,
        _build.stream_handle(x.device))
    launches += 1
    _build.check(status, "koala_gru_stack")
    return y, h_final


__all__ = ["gru_stack", "gru_stack_ref", "layers_step"]
