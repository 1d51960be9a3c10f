"""Training-data synthesis: noisy mixtures from speech/noise banks.

The reference ships no trainer (its model is a closed blob; SURVEY.md §5
checkpoint/resume: none) — this subsystem is new capability. It mirrors how
the reference's behavioral tests define correctness (binding/python/
test_koala.py:106-114): pure speech must pass through, pure noise must be
silenced, mixtures must recover the speech — so the sampler draws exactly
those three example types, with gain/SNR/speed augmentation plus synthetic
noise colors to widen the distribution beyond the bundled WAV pair.

The port's own copy of the JAX package's train/data.py (numpy only): the
same seed and input give bit-identical arrays in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import FRAME_LENGTH


def speed_perturb(x: np.ndarray, factor: float) -> np.ndarray:
    """Resample by linear interpolation (classic speed/pitch augmentation)."""
    n = int(len(x) / factor)
    idx = np.linspace(0.0, len(x) - 1.0, n)
    return np.interp(idx, np.arange(len(x)), x).astype(np.float32)


def synth_noise(rng: np.random.Generator, n: int, color: str) -> np.ndarray:
    """White/pink/brown noise at unit RMS."""
    w = rng.standard_normal(n).astype(np.float32)
    if color == "white":
        out = w
    else:
        spec = np.fft.rfft(w)
        freq = np.maximum(np.fft.rfftfreq(n), 1.0 / n)
        slope = 1.0 if color == "pink" else 2.0
        spec = spec / freq ** (slope / 2.0)
        out = np.fft.irfft(spec, n).astype(np.float32)
    rms = np.sqrt(np.mean(out ** 2)) + 1e-9
    return out / rms


class MixtureSampler:
    """Draws (noisy, clean) training pairs, float32 at fullscale 1.0.

    speech_bank / noise_bank: lists of float32 arrays in [-1, 1].
    """

    def __init__(
            self,
            speech_bank: Sequence[np.ndarray],
            noise_bank: Sequence[np.ndarray],
            segment_frames: int = 63,
            seed: int = 0,
            p_speech_only: float = 0.15,
            p_noise_only: float = 0.15,
            p_silence: float = 0.05):
        self.rng = np.random.default_rng(seed)
        self.segment = segment_frames * FRAME_LENGTH
        self.p_speech_only = p_speech_only
        self.p_noise_only = p_noise_only
        self.p_silence = p_silence

        # Pre-expand the speech bank with speed perturbations for variety.
        self.speech: List[np.ndarray] = []
        for s in speech_bank:
            s = np.asarray(s, np.float32)
            for f in (0.9, 1.0, 1.1):
                self.speech.append(speed_perturb(s, f) if f != 1.0 else s)
        self.noise = [np.asarray(x, np.float32) for x in noise_bank]

    def _crop(self, x: np.ndarray) -> np.ndarray:
        if len(x) <= self.segment:
            reps = -(-self.segment // len(x))
            x = np.tile(x, reps)
        start = self.rng.integers(0, len(x) - self.segment + 1)
        return x[start:start + self.segment].copy()

    def _draw_speech(self) -> np.ndarray:
        s = self._crop(self.speech[self.rng.integers(len(self.speech))])
        gain_db = self.rng.uniform(-22.0, 3.0)
        return s * 10.0 ** (gain_db / 20.0)

    def _draw_noise(self, ref_rms: float) -> np.ndarray:
        kind = self.rng.integers(0, 4)
        if kind == 0:
            n = synth_noise(self.rng, self.segment,
                            ["white", "pink", "brown"][self.rng.integers(3)])
            n = n * max(ref_rms, 1e-3)
        elif kind == 1 and len(self.speech) > 1:
            # babble: sum of shifted speech crops (hard, speech-like noise)
            n = sum(self._crop(self.speech[self.rng.integers(len(self.speech))])
                    for _ in range(4)) / 4.0
        else:
            n = self._crop(self.noise[self.rng.integers(len(self.noise))])
        return n

    def sample(self, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (noisy [B, segment], clean [B, segment]) float32."""
        noisy = np.zeros((batch, self.segment), np.float32)
        clean = np.zeros((batch, self.segment), np.float32)
        for b in range(batch):
            u = self.rng.random()
            if u < self.p_silence:
                continue  # silence -> silence
            if u < self.p_silence + self.p_speech_only:
                s = self._draw_speech()
                noisy[b] = s
                clean[b] = s
                continue
            s = self._draw_speech()
            s_rms = np.sqrt(np.mean(s ** 2)) + 1e-9
            n = self._draw_noise(s_rms)
            if u < self.p_silence + self.p_speech_only + self.p_noise_only:
                # pure noise -> silence target; level like real noise
                level = 10.0 ** (self.rng.uniform(-30.0, -6.0) / 20.0)
                n_rms = np.sqrt(np.mean(n ** 2)) + 1e-9
                scaled = n * (level / n_rms)
                peak = np.max(np.abs(scaled))
                if peak > 0.98:
                    scaled *= 0.98 / peak
                noisy[b] = scaled
                continue
            snr_db = self.rng.uniform(-5.0, 20.0)
            n_rms = np.sqrt(np.mean(n ** 2)) + 1e-9
            n = n * (s_rms / n_rms) * 10.0 ** (-snr_db / 20.0)
            mix = s + n
            peak = np.max(np.abs(mix))
            scale = min(1.0, 0.98 / peak) if peak > 0 else 1.0
            noisy[b] = mix * scale
            clean[b] = s * scale
        return noisy, clean


__all__ = ["MixtureSampler", "speed_perturb", "synth_noise"]
