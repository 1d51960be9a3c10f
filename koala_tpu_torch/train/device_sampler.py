"""On-device mixture sampler: all augmentation and mixing as tensor ops.

The small speech/noise "tapes" are uploaded once and every training batch is
cropped, gained and mixed on the tapes' device from one explicit
``torch.Generator`` on that device: the data pipeline runs inside the train
step with no host traffic per step.

The same example distribution as the JAX package's
``train/device_sampler.py`` (same classes, probabilities, ranges, caps and
``KOALA_AUG_*`` knobs): silence / speech-only / noise-only / mixtures, with
babble synthesized from overlapping speech crops. The two packages draw
different numbers from the same seed (``jax.random`` is not reproduced);
tests compare distributions and invariants, not samples. Synthetic noise
colors are pre-rendered into the noise tape by the caller.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from ..device import resolve_device

P_SILENCE = 0.05
P_SPEECH_ONLY = 0.25   # generous: the acceptance harness's hardest case is
P_NOISE_ONLY = 0.18    # perfect pass-through of clean speech
P_BABBLE = 0.30        # babble is the hardest pure-noise case (speech-like)
# Channel-augmentation application rates (training-recipe experiment knobs;
# env-overridable so sweeps don't need code edits).
P_TILT = float(os.environ.get("KOALA_AUG_TILT_P", "0.5"))
P_LEVELMOD = float(os.environ.get("KOALA_AUG_LEVELMOD_P", "0.3"))
# Static channel gain (dB, applied identically to input and target after
# mixture construction): explicit level invariance. Off by default; kept as
# an experiment knob.
P_GAIN = float(os.environ.get("KOALA_AUG_GAIN_P", "0.0"))
GAIN_DB_LO = float(os.environ.get("KOALA_AUG_GAIN_LO", "-9.0"))
GAIN_DB_HI = float(os.environ.get("KOALA_AUG_GAIN_HI", "3.0"))
# Max tilt slope (dB/oct). The pseudo-real eval battery tilts at exactly
# +-3 dB/oct (train/pseudo_real.py); training to +-4 puts the eval cases
# inside the augmentation support instead of at its edge.
TILT_DBOCT = float(os.environ.get("KOALA_AUG_TILT_DBOCT", "4.0"))


def sample_from_tapes(speech_tape: torch.Tensor, noise_tape: torch.Tensor,
                      generator: torch.Generator, batch: int, segment: int,
                      floor_tape: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tapes, generator) -> (noisy [B,S], clean [B,S]) float32 on the
    tapes' device. Every draw comes from ``generator`` (which must live on
    that device); crops are gathers, there is no loop over the batch."""
    seg = segment
    dev = speech_tape.device
    eps = 1e-9

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    def db(shape, lo, hi):
        return 10.0 ** (uniform(shape, lo, hi) / 20.0)

    def crops(tape, shape):
        starts = torch.randint(0, tape.shape[0] - seg + 1, shape, generator=generator,
                               device=dev)
        return tape.unfold(0, seg, 1)[starts]              # [*shape, seg]

    def rms(x):
        return torch.sqrt(torch.mean(x * x, dim=1, keepdim=True) + eps)

    def peak_scale(x):
        peak = x.abs().amax(dim=1, keepdim=True)
        return torch.clamp(0.98 / torch.clamp(peak, min=eps), max=1.0)

    s = crops(speech_tape, (batch,)) * db((batch, 1), -22.0, 3.0)

    n = crops(noise_tape, (batch,))
    # Babble: up to 8 overlapped talkers across three gain structures: 40%
    # sparse (u^6: one or two dominant talkers), 30% spread (u^2), 30% dense
    # (u^0.3: all talkers near equal, a crowd murmur).
    mode = uniform((batch, 1, 1))
    expo = torch.where(mode < 0.4, 6.0, torch.where(mode < 0.7, 2.0, 0.3))
    bg = uniform((batch, 8, 1)) ** expo
    talkers = crops(speech_tape, (batch, 8))
    babble = (talkers * bg).sum(dim=1) / torch.sqrt((bg * bg).sum(dim=1) + 1e-6)
    n_tape = n                      # the tape crop before babble replaces it
    n = torch.where(uniform((batch, 1)) < P_BABBLE, babble, n)

    s_rms, n_rms = rms(s), rms(n)

    # Two mixture parameterizations, half and half: relative SNR U[-5, 30] dB
    # and absolute noise level U[-40, -18] dBFS (the band real interference
    # occupies; noise at or below -45 dBFS under speech is recording floor).
    snr = uniform((batch, 1), -5.0, 30.0)
    n_rel = n * (s_rms / n_rms) * 10.0 ** (-snr / 20.0)
    n_abs = n * (db((batch, 1), -40.0, -18.0) / n_rms)
    n_mix = torch.where(uniform((batch, 1)) < 0.5, n_abs, n_rel)
    mix = s + n_mix
    scale = peak_scale(mix)
    mix = mix * scale
    s_mix = s * scale

    # Noise-only down to -45 dBFS: a stream with no speech anywhere must be
    # suppressed even when quiet. Its babble share (25%) is drawn apart from
    # the mixtures' babble flag.
    n_for_only = torch.where(uniform((batch, 1)) < 0.25, babble, n_tape)
    level = db((batch, 1), -45.0, -6.0)
    n_only = n_for_only * (level / rms(n_for_only))
    n_only = n_only * peak_scale(n_only)

    # Speech-only examples carry a faint recording floor in both input and
    # target: stationary shaped Gaussian hiss (random spectral slope, optional
    # band emphasis), never a crop of the structured noise tape. One
    # rfft/irfft pair per batch.
    white = torch.randn(s.shape, generator=generator, device=dev)
    spec = torch.fft.rfft(white, dim=-1)
    fg = torch.clamp(torch.fft.rfftfreq(seg, 1.0 / 16000.0, device=dev), min=1.0)[None, :]
    slope = uniform((batch, 1), 0.0, 2.0)
    shape = fg ** (-slope / 2.0)
    center = torch.exp(uniform((batch, 1), math.log(300.0), math.log(5000.0)))
    sigma = uniform((batch, 1), 0.4, 1.2)
    band = torch.exp(-0.5 * ((torch.log(fg) - torch.log(center)) / sigma) ** 2)
    shape = torch.where(uniform((batch, 1)) < 0.4, shape * (0.1 + band), shape)
    hiss = torch.fft.irfft(spec * shape, n=seg, dim=-1)
    hiss = hiss / rms(hiss)
    if floor_tape is not None:
        # half the floors come from the smooth structured floor tape
        # (corpus.build_floor_tape)
        fcrop = crops(floor_tape, (batch,))
        fcrop = fcrop / rms(fcrop)
        hiss = torch.where(uniform((batch, 1)) < 0.5, fcrop, hiss)
    # real recording floors lie far below interference: keep band -65..-50 dBFS
    s_floored = s + hiss * db((batch, 1), -65.0, -50.0)

    # Partial-suppression targets: mixtures keep a -18..-12 dB noise
    # residual, noise-only a -34..-24 dB one, both capped absolutely (the
    # harness bounds the residual at 0.02 fullscale per frame).
    beta = db((batch, 1), -18.0, -12.0)
    beta_n = db((batch, 1), -34.0, -24.0)
    beta_n = torch.minimum(beta_n, 0.006 / torch.clamp(level, min=eps))
    beta = torch.minimum(beta, 0.01 / torch.clamp(rms(n_mix), min=eps))

    u = uniform((batch, 1))
    zeros = torch.zeros_like(s)
    c1 = u < P_SILENCE
    c2 = u < P_SILENCE + P_SPEECH_ONLY
    c3 = u < P_SILENCE + P_SPEECH_ONLY + P_NOISE_ONLY
    noisy = torch.where(c1, zeros, torch.where(c2, s_floored, torch.where(c3, n_only, mix)))
    clean = torch.where(c1, zeros,
                        torch.where(c2, s_floored,
                                    torch.where(c3, beta_n * n_only,
                                                s_mix + beta * n_mix * scale)))

    # Channel augmentation, applied identically to input and target (a
    # channel is something to pass through, not undo): random spectral tilt
    # (20 Hz frequency floor, as the eval transform), static gain, slow level
    # modulation.
    fg_t = torch.clamp(fg, 20.0, 8000.0)
    slope_oct = uniform((batch, 1), -TILT_DBOCT, TILT_DBOCT)
    tilt_gain = 10.0 ** (slope_oct * torch.log2(fg_t / 1000.0) / 20.0)
    tilt_gain = torch.where(uniform((batch, 1)) < P_TILT, tilt_gain, 1.0)
    noisy = torch.fft.irfft(torch.fft.rfft(noisy, dim=-1) * tilt_gain, n=seg, dim=-1)
    clean = torch.fft.irfft(torch.fft.rfft(clean, dim=-1) * tilt_gain, n=seg, dim=-1)

    g_static = torch.where(uniform((batch, 1)) < P_GAIN,
                           db((batch, 1), GAIN_DB_LO, GAIN_DB_HI), 1.0)
    noisy = noisy * g_static
    clean = clean * g_static

    tgrid = (torch.arange(seg, device=dev) / 16000.0)[None, :]
    rate = uniform((batch, 1), 0.15, 0.7)
    phase = uniform((batch, 1), 0.0, 2.0 * math.pi)
    depth = uniform((batch, 1), 2.0, 6.0)
    lm = 10.0 ** (depth * torch.sin(2.0 * math.pi * rate * tgrid + phase) / 20.0)
    lm = torch.where(uniform((batch, 1)) < P_LEVELMOD, lm, 1.0)
    noisy = noisy * lm
    clean = clean * lm

    # tilt and fade can push peaks past fullscale; rescale both together
    g_scale = peak_scale(noisy)
    return noisy * g_scale, clean * g_scale


class DeviceSampler:
    """Holds the tapes on one device and samples repeatedly. ``device``: a
    device string as ``create`` takes it (``best``, the card, by default) or
    a ``torch.device``."""

    def __init__(self, speech_tape, noise_tape, segment: int, device="best",
                 floor_tape=None):
        if not isinstance(device, torch.device):
            device = resolve_device(device)

        def put(t):
            return None if t is None else torch.as_tensor(t, dtype=torch.float32,
                                                          device=device)
        self.speech, self.noise, self.floor = put(speech_tape), put(noise_tape), put(floor_tape)
        self.segment = segment
        if self.speech.shape[0] <= segment or self.noise.shape[0] <= segment:
            raise ValueError("tapes must be longer than one segment (%d samples)" % segment)

    def sample(self, generator: torch.Generator, batch: int):
        return sample_from_tapes(self.speech, self.noise, generator, batch,
                                 self.segment, floor_tape=self.floor)


__all__ = ["DeviceSampler", "sample_from_tapes"]
