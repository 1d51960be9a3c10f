"""Fused GRU-stack recurrence: CUDA kernel, its plain version, its gradient.

``gru_stack`` replaces the JAX package's TPU kernel ``gru_stack_pallas``
(ops/pallas/gru.py:103, kernel body :60) in both of its traced variants.
Per step and layer, with x_0 = x[t] (bf16):

    xp = bf16(x_l) @ wx_l + bx_l,  hp = bf16(h_l) @ wh_l + bh_l   (f32 sums)
    z, r, n gates as _gru_gates (gru.py:50-57), h_l' = (1-z) n + z h_l
    x_{l+1} = x_l + h_l' in f32, re-cast to bf16;  y[t] = x_L

With ``return_hidden`` the kernel also streams the post-update state of
every layer at every step out as ``hs [T, L, B, H]`` f32, the residuals of
the backward pass. ``gru_stack_trainable`` is the differentiable form: the
``return_hidden`` kernel forward, and a reverse-time pass in plain PyTorch
over ``hs`` as backward (the JAX package's backward, gru.py:253-272, is a
plain reverse scan too, not a kernel). The card's training variant writes
``hs`` straight to device memory and needs no more shared memory than the
inference variant, so, unlike the TPU's shape gate, there is no branch that
falls back from the kernel to the scan for training.

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

# launches of the CUDA kernel since the last reset (plain integers): the
# inference variant and the return_hidden (training) variant
launches = 0
launches_hs = 0


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


def gru_stack_ref(h0, x, wx, bx, wh, bh, return_hidden: bool = False):
    """Plain version: h0 [L,B,H] f32, x [T,B,H] -> (y [T,B,H] bf16,
    h_final [L,B,H] f32), with ``return_hidden`` (y, hs [T,L,B,H] f32,
    h_final)."""
    h = h0.float()
    wx, wh = wx.bfloat16(), wh.bfloat16()
    ys, hs = [], []
    for t in range(x.shape[0]):
        h, y_t = layers_step(h, x[t].bfloat16(), wx, bx.float(), wh, bh.float())
        ys.append(y_t)
        hs.append(h)
    y = torch.stack(ys) if ys else x.bfloat16()
    if not return_hidden:
        return y, h
    return y, (torch.stack(hs) if hs else h.new_zeros((0,) + tuple(h.shape))), h


def gru_stack(h0, x, wx, bx, wh, bh, return_hidden: bool = False):
    """Run the L-layer GRU recurrence over T steps: (y, h_final), or
    (y, hs, h_final) with ``return_hidden``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    global launches, launches_hs
    if x.device.type == "cpu":
        return gru_stack_ref(h0, x, wx, bx, wh, bh, return_hidden)
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
    # allocated per call: at B = 128, T = 125 it is 49 MB, not worth keeping
    hs = (torch.empty((t_len, layers, b, hidden), dtype=torch.float32, device=x.device)
          if return_hidden else None)
    status = lib.koala_gru_stack(
        x.data_ptr(), h0.data_ptr(), wx.data_ptr(), bx.data_ptr(), wh.data_ptr(),
        bh.data_ptr(), y.data_ptr(), hs.data_ptr() if return_hidden else None,
        h_final.data_ptr(), t_len, b, hidden, layers, _build.stream_handle(x.device))
    if return_hidden:
        launches_hs += 1
    else:
        launches += 1
    _build.check(status, "koala_gru_stack")
    return (y, hs, h_final) if return_hidden else (y, h_final)


def _round_bf16(t):
    """The cotangent of a bf16 operand comes back rounded to bf16."""
    return t.bfloat16().float()


def gru_stack_backward(h0, x, wx, bx, wh, bh, hs, ct_y, ct_hf):
    """Reverse-time pass of the stack over the streamed states ``hs``:
    cotangents (ct_y [T,B,H], ct_hf [L,B,H]) -> (dh0, dx, dwx, dbx, dwh, dbh),
    all float32. Nothing of the recurrence is run again: the state before
    step t is h0 or hs[t-1], each layer's input is x[t] plus the states below
    it, so every gate is recomputed for all T at once (four large products),
    and only the two cotangent products per layer and step stay sequential.
    The weight gradients are summed over T by one product each."""
    t_len, layers = hs.shape[0], hs.shape[1]
    wxf, whf = wx.bfloat16().float(), wh.bfloat16().float()
    bx, bh = bx.float(), bh.float()
    h_prev = torch.cat([h0.float().unsqueeze(0), hs[:-1]], dim=0)        # [T,L,B,H]
    # layer inputs: x_f accumulates the states below in f32, re-cast to bf16
    x_f = x.bfloat16().float()
    x_in = []
    for l in range(layers):
        x_in.append(x_f.bfloat16().float())
        x_f = x_f + hs[:, l]
    hb = h_prev.bfloat16().float()
    gx, gh, zs = [], [], []
    for l in range(layers):
        xp = x_in[l] @ wxf[l] + bx[l]
        hp = hb[:, l] @ whf[l] + bh[l]
        xz, xr, xn = xp.chunk(3, dim=-1)
        hz, hr, hn = hp.chunk(3, dim=-1)
        z = torch.sigmoid(xz + hz)
        r = torch.sigmoid(xr + hr)
        n = torch.tanh(xn + r * hn)
        # h' = (1-z) n + z h: d(pre-activation) per unit of dh'
        a_n = (1.0 - z) * (1.0 - n * n)
        a_z = (h_prev[:, l] - n) * z * (1.0 - z)
        a_r = a_n * hn * r * (1.0 - r)
        gx.append(torch.cat([a_z, a_r, a_n], dim=-1))                    # -> d xp
        gh.append(torch.cat([a_z, a_r, a_n * r], dim=-1))                # -> d hp
        zs.append(z)
    wxt = wxf.transpose(1, 2).contiguous()
    wht = whf.transpose(1, 2).contiguous()
    dxp = [torch.empty_like(g) for g in gx]
    dhp = [torch.empty_like(g) for g in gh]
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    dh = ct_hf.float()
    ct_y = ct_y.bfloat16().float()
    for t in range(t_len - 1, -1, -1):
        dxf = ct_y[t]
        dh_prev = [None] * layers
        for l in range(layers - 1, -1, -1):
            dhn3 = (dh[l] + dxf).repeat(1, 3)
            torch.mul(dhn3, gx[l][t], out=dxp[l][t])
            torch.mul(dhn3, gh[l][t], out=dhp[l][t])
            dh_prev[l] = dhn3[:, :zs[l].shape[-1]] * zs[l][t] + _round_bf16(dhp[l][t] @ wht[l])
            dxf = dxf + _round_bf16(dxp[l][t] @ wxt[l])
        dx[t] = dxf
        dh = dh_prev
    dh0 = torch.stack(dh) if t_len else ct_hf.float()
    flat = lambda a: a.reshape(-1, a.shape[-1])
    dwx = torch.stack([flat(x_in[l]).t() @ flat(dxp[l]) for l in range(layers)])
    dwh = torch.stack([flat(hb[:, l]).t() @ flat(dhp[l]) for l in range(layers)])
    dbx = torch.stack([flat(dxp[l]).sum(0) for l in range(layers)])
    dbh = torch.stack([flat(dhp[l]).sum(0) for l in range(layers)])
    return dh0, dx, dwx, dbx, dwh, dbh


class _GruStackTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h0, x, wx, bx, wh, bh):
        y, hs, h_final = gru_stack(
            h0.float().contiguous(), x.bfloat16().contiguous(), wx.bfloat16().contiguous(),
            bx.float().contiguous(), wh.bfloat16().contiguous(), bh.float().contiguous(),
            return_hidden=True)
        ctx.save_for_backward(h0, x, wx, bx, wh, bh, hs)
        return y, h_final

    @staticmethod
    def backward(ctx, ct_y, ct_hf):
        h0, x, wx, bx, wh, bh, hs = ctx.saved_tensors
        grads = gru_stack_backward(h0, x, wx, bx, wh, bh, hs, ct_y, ct_hf)
        # each gradient in its input's dtype (dx in x's, as the JAX backward)
        return tuple(g.to(inp.dtype)
                     for g, inp in zip(grads, (h0, x, wx, bx, wh, bh)))


def gru_stack_trainable(h0, x, wx, bx, wh, bh):
    """Differentiable ``gru_stack``: (y [T,B,H] bf16, h_final [L,B,H] f32).
    Forward is the ``return_hidden`` kernel (the plain version for CPU
    tensors), backward ``gru_stack_backward`` over the states it streamed
    out. The weights may be float32 (they are rounded to bf16 for the
    products, and their gradients come back float32)."""
    return _GruStackTrainable.apply(h0, x, wx, bx, wh, bh)


__all__ = ["gru_stack", "gru_stack_ref", "gru_stack_trainable", "gru_stack_backward",
           "layers_step"]
