"""Trainer for the learned mask estimator.

Loss = negative SNR (scale-sensitive, because the acceptance harness checks
absolute per-frame energy) + spectral magnitude L1 + per-frame RMS deviation
+ a speech-distortion term on the mask. The same loss, optimizer and
schedule as the JAX package's ``train/train.py``; the forward pass is the
engine's ``sequence_full`` and, on a card, goes through the differentiable
kernel wrappers of ``ops/kernels`` (GRU ``return_hidden`` kernel forward,
floor kernel forward, plain backward passes).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise ``KoalaInvalidArgumentError``. With a ``mesh``
(``parallel/mesh.py``), ``make_train_step`` and ``train`` are data-parallel
replicas, one device a process: each process computes the loss on its slice
of the global batch, and one all-reduce a step averages the gradients (and
the loss) before the optimizer, which runs replicated.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..constants import DELAY_SAMPLE, FRAME_LENGTH
from ..device import resolve_device
from ..engine.core import make_engine
from ..errors import ERROR_STACK, KoalaInvalidArgumentError, raise_with_stack
from ..models import mask_gru
from ..models.params_io import params_from_numpy
from ..parallel.mesh import Mesh
from ..ops import stft as stft_ops
from .data import MixtureSampler


def delayed(target: torch.Tensor, delay: int = DELAY_SAMPLE) -> torch.Tensor:
    """Shift target right by the engine delay so it aligns with the output."""
    pad = target.new_zeros(target.shape[:-1] + (delay,))
    return torch.cat([pad, target[..., :-delay]], dim=-1)


def snr_loss(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Negative SNR in dB, scale-sensitive, safe for silent targets (for a
    silent ref it degrades to -10 log10(eps / (err + eps)): pushes err -> 0)."""
    err = torch.sum((est - ref) ** 2, dim=-1)
    sig = torch.sum(ref ** 2, dim=-1)
    return torch.mean(10.0 * torch.log10((err + eps) / (sig + eps)))


def frame_rms_l1(est: torch.Tensor, ref: torch.Tensor, under_weight: float = 4.0,
                 topk_weight: float = 4.0) -> torch.Tensor:
    """Per-frame RMS deviation over 256-sample frames, the quantity the
    acceptance harness bounds (< 0.02 at fullscale 1.0).

    Asymmetric: under-shoot (est quieter than ref: speech attenuation) is
    weighted ``under_weight`` x. Frames with ref RMS in [0.02, 0.15] (where
    the worst-frame failures live) count twice, the first 12 frames of a
    segment (a fresh stream) twice. The harness scores the worst frame, so
    the mean of the worst 1/16 of frames per example is added with
    ``topk_weight``, and a hinge at half the tolerance on the raw deviation."""
    def frms(x):
        b, s = x.shape
        fr = x.reshape(b, s // FRAME_LENGTH, FRAME_LENGTH)
        return torch.sqrt(torch.mean(fr * fr, dim=-1) + 1e-10)

    ref_rms = frms(ref)
    d = frms(est) - ref_rms
    d_raw = d.abs()                                       # [B, F] harness domain
    d = torch.where(d < 0, -under_weight * d, d)
    critical = (ref_rms > 0.02) & (ref_rms < 0.15)
    d = torch.where(critical, 2.0 * d, d)
    n_early = min(12, d.shape[1])
    early = torch.cat([d.new_full((n_early,), 2.0), d.new_ones((d.shape[1] - n_early,))])
    d = d * early[None, :]
    k = max(1, d.shape[1] // 16)
    worst = torch.topk(d, k, dim=-1)[0]                   # [B, k]
    hinge = torch.clamp(d_raw - 0.01, min=0.0)
    return torch.mean(d) + topk_weight * torch.mean(worst) + 25.0 * torch.mean(hinge)


def spectral_l1(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """L1 between STFT magnitudes of est/ref waveforms [B, T*hop]."""
    def mags(x):
        re, im = stft_ops.stft_frame(stft_ops.frame_signal(x))
        return torch.sqrt(re * re + im * im + 1e-10)

    return torch.mean(torch.abs(mags(est) - mags(ref)))


# Speech-distortion (mask-preservation) weight, the intelligibility lever.
# Env-overridable for training-recipe sweeps.
_DISTORTION_W = float(os.environ.get("KOALA_LOSS_DISTORTION_W", "20.0"))


def make_loss_fn(config: Dict[str, Any]) -> Callable:
    """-> loss_fn(params, noisy [B,S], clean [B,S]) -> scalar loss, on the
    device of ``noisy``. Every segment starts from a fresh engine state."""
    engine = make_engine(config.get("kind", "mask_gru"), config)

    def loss_fn(params, noisy, clean):
        b, s = noisy.shape
        hops = noisy.reshape(b, s // FRAME_LENGTH, FRAME_LENGTH)
        state = engine.init_state((b,), noisy.device)
        _, out, mask, _ = engine.sequence_full(params, state, hops)
        est = out.reshape(b, s)
        ref = delayed(clean)

        # Speech-distortion term: the mask applied to the clean spectrum must
        # preserve it. Sqrt-compressed magnitude (quiet speech counts), gated
        # by the speech dominance mag_c / mag_noisy (no penalty where the
        # clean target is a small fraction of the input), and weighted 3x in
        # 1.5-4.3 kHz, where the intelligibility loss concentrates.
        def mags(x_wave):
            re_, im_ = stft_ops.stft_frame(stft_ops.frame_signal(x_wave))
            return torch.sqrt(re_ * re_ + im_ * im_ + 1e-10)

        mag_c = mags(clean)
        mag_y = mags(noisy)
        dominance = torch.clamp(mag_c / (mag_y + 1e-8), 0.0, 1.0)
        k = mask.shape[-1]
        freq = torch.arange(k, device=mask.device) * (8000.0 / (k - 1))
        band_w = 1.0 + 2.0 * torch.clamp((freq - 1200.0) / 800.0, 0.0, 1.0) \
            * torch.clamp((4800.0 - freq) / 500.0, 0.0, 1.0)
        distortion = torch.mean((1.0 - mask) * torch.sqrt(mag_c) * dominance * band_w)

        return (snr_loss(est, ref) + 20.0 * spectral_l1(est, ref)
                + 90.0 * frame_rms_l1(est, ref) + _DISTORTION_W * distortion)

    return loss_fn


def warmup_cosine_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """The trainer's learning-rate schedule as a function of the update count:
    linear warm-up from 0.05 lr to lr over max(steps // 20, 10) updates, then
    a cosine decay to 0.02 lr at ``steps``."""
    init, peak, end = lr * 0.05, lr, lr * 0.02
    warmup = max(steps // 20, 10)
    decay = steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return init + (peak - init) * count / warmup
        if decay <= 0:
            return end
        frac = min(count - warmup, decay) / decay
        alpha = end / peak
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


class ClippedAdamW:
    """Gradient clipping by global norm (g * max_norm / norm where
    norm > max_norm, nothing added to the norm), then AdamW (betas 0.9,
    0.999, eps 1e-8, weight decay on every leaf, biases too) at a scheduled
    learning rate. ``step`` updates the parameters in place."""

    def __init__(self, params, schedule: Callable[[int], float], max_norm: float = 1.0,
                 weight_decay: float = 1e-5):
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = max_norm
        self.adamw = torch.optim.AdamW(self.params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        # a tensor factor: no host round trip to branch on the norm
        factor = torch.where(norm > self.max_norm, self.max_norm / norm, torch.ones_like(norm))
        torch._foreach_mul_(grads, factor)
        self.adamw.step()
        self.scheduler.step()


def make_optimizer(params, lr: float, steps: int) -> ClippedAdamW:
    """The trainer's optimizer for a run of ``steps`` updates at peak ``lr``."""
    return ClippedAdamW(params.parameters(), warmup_cosine_schedule(lr, steps))


def make_train_step(config: Dict[str, Any], optimizer, mesh: Optional[Mesh] = None) -> Callable:
    """-> train_step(params, noisy, clean) -> loss (a detached scalar
    tensor). One forward and backward pass and one optimizer update, in
    place on ``params``. ``optimizer`` has ``zero_grad()`` and ``step()``
    (``make_optimizer``, or any ``torch.optim`` optimizer over the
    parameters).

    With a ``mesh`` of one device (this process's), ``noisy`` and ``clean``
    are the global batch: the step takes this process's rows
    (``Mesh.local_rows``) to its device, and after the backward pass one
    ``all_reduce(SUM)`` over the mesh's process group carries the flattened
    gradients and the loss, divided by the number of processes. The
    optimizer then clips and applies the averaged gradient on every process
    alike, so the parameters stay bit-identical across processes. The
    analog of the JAX package's ``shard_map`` path, with no collective but
    that one."""
    loss_fn = make_loss_fn(config)
    if mesh is None:
        def train_step(params, noisy, clean):
            optimizer.zero_grad()
            loss = loss_fn(params, noisy, clean)
            loss.backward()
            optimizer.step()
            return loss.detach()

        return train_step

    if not isinstance(mesh, Mesh) or len(mesh.devices) != 1:
        ERROR_STACK.push("make_train_step(mesh=...): expected a parallel.Mesh with one device "
                         "a process, got %r" % (mesh,))
        raise_with_stack(KoalaInvalidArgumentError, "Invalid mesh argument")
    device = mesh.devices[0]

    def train_step(params, noisy, clean):
        lo, hi = mesh.local_rows(noisy.shape[0])
        optimizer.zero_grad()
        loss = loss_fn(params, noisy[lo:hi].to(device), clean[lo:hi].to(device))
        loss.backward()
        leaves = [p for p in params.parameters() if p.requires_grad]
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in leaves] + [loss.detach().reshape(1)])
        if mesh.group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat /= mesh.world
        for p, g in zip(leaves, torch.split(flat[:-1], [p.numel() for p in leaves])):
            p.grad = g.view_as(p)
        optimizer.step()
        return flat[-1]

    return train_step


def _trainable_params(params, cfg, seed: int, device: torch.device):
    """A fresh seeded model, or the caller's (module or numpy tree), on
    ``device`` with every weight taking a gradient."""
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = mask_gru.init_params(gen, cfg)
    elif not isinstance(params, torch.nn.Module):
        params = params_from_numpy(params, device, "mask_gru")
    return params.to(device).requires_grad_(True)


def _log(step_i: int, loss, t0: float) -> None:
    # the scalar fetch is the only synchronisation with the device
    print("step %5d  loss %.4f  (%.1fs)" % (step_i, float(loss), time.perf_counter() - t0),
          flush=True)


def train(speech_bank, noise_bank, steps: int = 4000, batch: int = 64,
          segment_frames: int = 63, lr: float = 3e-4, seed: int = 0,
          config: Optional[Dict[str, Any]] = None, mesh=None, log_every: int = 200,
          params=None, device: str = "best") -> Tuple[Any, Dict[str, Any]]:
    """Train the mask_gru model on batches mixed on the host
    (``MixtureSampler``); returns (params, config). With a ``mesh``, every
    process draws the same global batch from ``seed`` and trains on its
    slice, on the mesh's device (``device`` is then not used)."""
    cfg = dict(mask_gru.DEFAULT_CONFIG, **(config or {}))
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    params = _trainable_params(params, cfg, seed, dev)
    train_step = make_train_step(cfg, make_optimizer(params, lr, steps), mesh)
    sampler = MixtureSampler(speech_bank, noise_bank, segment_frames=segment_frames, seed=seed)

    t0 = time.perf_counter()
    for step_i in range(steps):
        noisy, clean = sampler.sample(batch)
        # with a mesh the step moves only this process's rows to the device
        on = None if mesh is not None else dev
        loss = train_step(params, torch.as_tensor(noisy, device=on),
                          torch.as_tensor(clean, device=on))
        if log_every and (step_i % log_every == 0 or step_i == steps - 1):
            _log(step_i, loss, t0)
    return params.requires_grad_(False), cfg


def train_on_device(speech_tape: np.ndarray, noise_tape: np.ndarray, steps: int = 4000,
                    batch: int = 64, segment_frames: int = 63, lr: float = 3e-4,
                    seed: int = 0, config: Optional[Dict[str, Any]] = None,
                    log_every: int = 200, params=None,
                    floor_tape: Optional[np.ndarray] = None,
                    device: str = "best") -> Tuple[Any, Dict[str, Any]]:
    """Training with the data pipeline on the device (``sample_from_tapes``):
    the only host traffic is the one-time tape upload and the periodic loss
    fetches. Returns (EMA of the weights, config): the average of the late
    trajectory (decay 0.999, zero-initialised and debiased by 1 - d^t), which
    is more robust on the worst frame than the last iterate."""
    from .device_sampler import sample_from_tapes

    cfg = dict(mask_gru.DEFAULT_CONFIG, **(config or {}))
    dev = resolve_device(device)
    params = _trainable_params(params, cfg, seed, dev)
    train_step = make_train_step(cfg, make_optimizer(params, lr, steps))

    segment = segment_frames * FRAME_LENGTH
    speech_dev = torch.as_tensor(speech_tape, dtype=torch.float32, device=dev)
    noise_dev = torch.as_tensor(noise_tape, dtype=torch.float32, device=dev)
    floor_dev = (torch.as_tensor(floor_tape, dtype=torch.float32, device=dev)
                 if floor_tape is not None else None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    ema_decay = 0.999
    if steps * (1.0 - ema_decay) < 5.0:
        print("WARNING: steps=%d is short for EMA decay %.3f — the "
              "averaged weights cover < 5 EMA horizons" % (steps, ema_decay), flush=True)
    leaves = list(params.parameters())
    ema = [torch.zeros_like(p) for p in leaves]           # never aliases the weights

    t0 = time.perf_counter()
    for i in range(steps):
        noisy, clean = sample_from_tapes(speech_dev, noise_dev, gen, batch, segment,
                                         floor_tape=floor_dev)
        loss = train_step(params, noisy, clean)
        with torch.no_grad():
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, leaves, alpha=1.0 - ema_decay)
        if log_every and (i % log_every == 0 or i == steps - 1):
            _log(i, loss, t0)
    debias = 1.0 - ema_decay ** max(steps, 1)
    with torch.no_grad():
        for p, e in zip(leaves, ema):
            p.copy_(e / debias)
    return params.requires_grad_(False), cfg


__all__ = ["train", "train_on_device", "make_train_step", "make_loss_fn", "make_optimizer",
           "ClippedAdamW", "warmup_cosine_schedule", "snr_loss", "spectral_l1",
           "frame_rms_l1", "delayed"]
