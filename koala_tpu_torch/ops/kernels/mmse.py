"""The mmse model's gain recurrence: CUDA kernel and its plain version.

It replaces no TPU kernel: the JAX package's ``models/mmse.py`` runs the
decision-directed gain as a ``lax.scan`` of plain ``jnp``, outside any
Pallas kernel. In PyTorch that scan is a Python loop of about 29 elementwise
launches a frame, so a corpus wash waited on the host's launches; the kernel
(csrc/mmse.cu) walks all T frames in one launch.

On this card the work is bound by bytes (re and im read once, the mask
written once, the state both ways; no products). The recurrence is
elementwise in (stream, bin), so the kernel gives each thread one column
(n, k) and carries the state over T in registers; each thread stages its
own column's next frames in shared memory (cp.async). Its arithmetic is
``gain_frame``'s, operation by operation (no FMA contraction, IEEE
divisions), so its masks and state are bit-identical to ``mmse_gain_ref``
on the card: a stream's output does not depend on whether a frame went
through ``step`` or through a sequence call.
"""

from __future__ import annotations

import torch

from ... import profiling
from . import _build

# launches of the CUDA kernel since the last reset (a plain integer)
launches = 0

# the noise PSD's floor, and the floor of the PSD that divides the power
NOISE_MIN = 1e-10


def gain_frame(re, im, noise, prev_gain2_post, count, dd_beta: float, noise_alpha: float,
               gain_floor: float, snr_cap: float):
    """One frame of the gain rule, elementwise over [*, K] bins (count [*]):
    -> (noise', prev_gain2_post', count', mask [*, K]). The plain chain of
    ``models/mmse.py`` ``step``; the kernel repeats it operation by operation."""
    power = re * re + im * im

    # fast adaptation over the first frames (the stream head is taken as the
    # noise reference), then the steady-state smoothing constant
    boot = torch.clamp(1.0 / (count + 1.0), 1.0 - noise_alpha, 1.0)[..., None]

    gamma = torch.clamp(power / torch.clamp(noise, min=NOISE_MIN), 0.0, snr_cap)
    xi = (dd_beta * prev_gain2_post
          + (1.0 - dd_beta) * torch.clamp(gamma - 1.0, min=0.0))   # a-priori SNR
    xi = torch.clamp(xi, 0.0, snr_cap)
    gain = xi / (1.0 + xi)                                          # Wiener rule

    # the speech-presence probability xi / (1 + xi) gates noise updates; its
    # complement is computed as 1 / (1 + xi) (1 - presence cancels for large xi)
    rate = boot / (1.0 + xi)
    new_noise = torch.clamp(noise + rate * (power - noise), min=NOISE_MIN)

    mask = torch.clamp(gain, min=gain_floor)
    return (new_noise, torch.clamp(gain * gain * gamma, 0.0, snr_cap), count + 1.0, mask)


def mmse_gain_ref(re, im, noise, prev_gain2_post, count, dd_beta: float, noise_alpha: float,
                  gain_floor: float, snr_cap: float):
    """Plain version: re, im [N, T, K] f32, noise and prev_gain2_post [N, K],
    count [N] -> (noise', prev_gain2_post', count', mask [N, T, K]), a loop of
    ``gain_frame`` over T."""
    masks = []
    for t in range(re.shape[1]):
        noise, prev_gain2_post, count, mask = gain_frame(
            re[:, t], im[:, t], noise, prev_gain2_post, count, dd_beta, noise_alpha,
            gain_floor, snr_cap)
        masks.append(mask)
    if not masks:
        return noise, prev_gain2_post, count, re.new_zeros(re.shape)
    return noise, prev_gain2_post, count, torch.stack(masks, dim=1)


def mmse_gain(re, im, noise, prev_gain2_post, count, dd_beta: float, noise_alpha: float,
              gain_floor: float, snr_cap: float):
    """The gain recurrence over T frames, in ``mmse_gain_ref``'s form. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or raise)."""
    global launches
    if re.device.type == "cpu":
        return mmse_gain_ref(re, im, noise, prev_gain2_post, count, dd_beta, noise_alpha,
                             gain_floor, snr_cap)
    if re.dim() != 3 or re.shape[2] < 1:
        raise ValueError("mmse_gain: re must be [N, T, K] with K >= 1, got %s"
                         % (tuple(re.shape),))
    n, t_len, k = re.shape
    _build.require_cuda(re, "mmse_gain re", torch.float32)
    _build.require_cuda(im, "mmse_gain im", torch.float32, (n, t_len, k))
    _build.require_cuda(noise, "mmse_gain noise", torch.float32, (n, k))
    _build.require_cuda(prev_gain2_post, "mmse_gain prev_gain2_post", torch.float32, (n, k))
    _build.require_cuda(count, "mmse_gain count", torch.float32, (n,))
    lib = _build.library()
    mask = torch.empty_like(re)
    new_noise, new_prev, new_count = (torch.empty_like(noise), torch.empty_like(prev_gain2_post),
                                      torch.empty_like(count))
    status = lib.koala_mmse_gain(
        re.data_ptr(), im.data_ptr(), noise.data_ptr(), prev_gain2_post.data_ptr(),
        count.data_ptr(), mask.data_ptr(), new_noise.data_ptr(), new_prev.data_ptr(),
        new_count.data_ptr(), n, t_len, k, dd_beta, 1.0 - dd_beta, 1.0 - noise_alpha,
        gain_floor, snr_cap, NOISE_MIN, _build.stream_handle(re.device))
    launches += 1
    _build.check(status, "koala_mmse_gain")
    return new_noise, new_prev, new_count, mask


def bound(t_len: int, n: int, k: int):
    """Least time (ms) of the gain recurrence over re, im [n, t_len, k] f32 on
    an H100 (``profiling.bound``): re, im and the mask once each, the state
    (noise and prev_gain2_post [n, k], count [n]) both ways; no products."""
    return profiling.bound((3 * n * t_len * k + 4 * n * k + 2 * n) * 4, 0, 0)


__all__ = ["gain_frame", "mmse_gain", "mmse_gain_ref", "bound", "NOISE_MIN"]
