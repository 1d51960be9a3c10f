"""Pseudo-real eval variants of the one real recording available.

The reference engine works on ANY real input unconditionally (its harness
runs on an arbitrary bundled recording, binding/python/test_koala.py:
106-114), but our corpus is synthetic by necessity — so the broadest
available generalization evidence is an invariance battery: transforms of
the reference pair that a robust enhancer must be invariant to, each run
through the full parity harness at the same 0.02 tolerance.

Transforms (all applied identically to the speech and noise fixtures so
the harness's delay-shifted comparisons stay aligned):
- gain shift (-6 dB): recording level invariance
- resampling (0.9x / 1.1x): pitch/formant ("different speaker") shifts
- reverb: short synthetic RIR (direct path + 64 ms exponentially decaying
  diffuse tail at -15 dB direct-to-reverb) — room acoustics
- spectral tilt (+-3 dB/octave re 1 kHz): microphone/channel coloration
- mu-law round trip (G.711, mu=255): telephony codec quantization
- slow level modulation (+-6 dB sinusoid at 0.4 Hz): fading talkers /
  automatic gain control motion

The port's own copy of the JAX package's train/pseudo_real.py (numpy only): the
same seed and input give bit-identical arrays in both packages.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray]


def _resample(x: np.ndarray, factor: float) -> np.ndarray:
    """Linear-interp resample by ``factor`` (pitch/formant shift)."""
    n = int(len(x) / factor)
    idx = np.arange(n) * factor
    return np.interp(idx, np.arange(len(x)),
                     x.astype(np.float64)).astype(np.int16)


def _to_i16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def _reverb(x: np.ndarray, seed: int = 11) -> np.ndarray:
    """Convolve with a mild synthetic room impulse response."""
    rng = np.random.default_rng(seed)
    n_tail = 1024                                # 64 ms @ 16 kHz
    t = np.arange(n_tail) / 16000.0
    tail = rng.standard_normal(n_tail) * np.exp(-t / 0.02)   # RT60 ~ 0.28 s
    tail *= 10.0 ** (-15.0 / 20.0) / max(np.sqrt(np.sum(tail ** 2)), 1e-9)
    rir = np.concatenate([[1.0], tail])
    y = np.convolve(x.astype(np.float64), rir)[: len(x)]
    return _to_i16(y)


def _tilt(x: np.ndarray, db_per_oct: float) -> np.ndarray:
    """Spectral tilt of ``db_per_oct`` re 1 kHz via full-signal FFT."""
    n = len(x)
    spec = np.fft.rfft(x.astype(np.float64))
    f = np.fft.rfftfreq(n, d=1.0 / 16000.0)
    f = np.maximum(f, 20.0)
    gain = 10.0 ** (db_per_oct * np.log2(f / 1000.0) / 20.0)
    y = np.fft.irfft(spec * gain, n=n)
    peak = np.max(np.abs(y))
    if peak > 32000.0:
        y *= 32000.0 / peak
    return _to_i16(y)


def _mulaw(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    """G.711-style mu-law companding round trip (8-bit levels)."""
    f = x.astype(np.float64) / 32768.0
    comp = np.sign(f) * np.log1p(mu * np.abs(f)) / np.log1p(mu)
    q = np.round(comp * 127.0) / 127.0
    dec = np.sign(q) * ((1.0 + mu) ** np.abs(q) - 1.0) / mu
    return _to_i16(dec * 32768.0)


def _level_mod(x: np.ndarray, depth_db: float = 6.0,
               rate_hz: float = 0.4) -> np.ndarray:
    """Slow sinusoidal gain envelope (+-depth_db)."""
    t = np.arange(len(x)) / 16000.0
    g = 10.0 ** (depth_db * np.sin(2.0 * np.pi * rate_hz * t) / 20.0)
    return _to_i16(x.astype(np.float64) * g)


def variants(speech: np.ndarray, noise: np.ndarray) -> Dict[str, Pair]:
    """All pseudo-real (speech, noise) eval pairs, keyed by case name."""
    speech = np.asarray(speech, np.int16)
    noise = np.asarray(noise, np.int16)
    return {
        "-6dB": ((speech // 2).astype(np.int16), (noise // 2).astype(np.int16)),
        "rs0.9": (_resample(speech, 0.9), _resample(noise, 0.9)),
        "rs1.1": (_resample(speech, 1.1), _resample(noise, 1.1)),
        "reverb": (_reverb(speech), _reverb(noise, seed=12)),
        "tilt+3": (_tilt(speech, 3.0), _tilt(noise, 3.0)),
        "tilt-3": (_tilt(speech, -3.0), _tilt(noise, -3.0)),
        "mulaw": (_mulaw(speech), _mulaw(noise)),
        "levelmod": (_level_mod(speech), _level_mod(noise)),
    }


__all__ = ["variants"]
