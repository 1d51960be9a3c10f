"""Frequency-weighted segmental SNR (fwSNRseg) — the second objective
quality metric reported beside STOI/SI-SDR.

Why this metric: BASELINE.json asks for "SI-SDR/PESQ parity" with the
reference engine. PESQ (ITU-T P.862) itself is a licensed, ~5k-line
psychoacoustic model; re-implementing it from scratch would be both large
and unverifiable here (no conformance vectors available offline). The
published alternative with the HIGHEST correlation to PESQ across noise-
suppression systems is frequency-weighted segmental SNR: Hu & Loizou,
"Evaluation of objective quality measures for speech enhancement", IEEE
TASLP 16(1), 2008, report r ~= 0.81-0.85 vs PESQ / subjective MOS on the
NOIZEUS corpus (table of correlations; fwSNRseg and PESQ were the top two
measures). STOI (Taal et al., ICASSP 2010) covers the intelligibility
axis. Together: STOI = intelligibility, fwSNRseg = perceptual quality
proxy, SI-SDR = scale-sensitive fidelity. See
resources/reports/QUALITY_METRICS.md for the full substitution argument.

Definition (Hu & Loizou 2008, eq. (1)): per 30 ms Hann frame m (75%
overlap) and mel-spaced band j of the magnitude spectrum,
    SNR(j,m) = 10 log10( X(j,m)^2 / (X(j,m) - X_hat(j,m))^2 )
clamped to [-10, 35] dB, averaged over bands with weights W(j,m) =
X(j,m)^gamma (gamma = 0.2), then averaged over speech-active frames.

The port's own copy of the JAX package's train/fwsnrseg.py (numpy only): the
same seed and input give bit-identical arrays in both packages.
"""

from __future__ import annotations

import functools

import numpy as np

K_BANDS = 25
GAMMA = 0.2
FRAME = 480          # 30 ms @ 16 kHz
HOP = 120            # 75% overlap
SNR_LO, SNR_HI = -10.0, 35.0


@functools.lru_cache(maxsize=4)
def _mel_bands(n_fft: int, sr: int = 16000, nb: int = K_BANDS) -> np.ndarray:
    """[n_fft//2+1, nb] triangular mel filterbank (area-normalized)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    bins = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(50.0), hz_to_mel(sr / 2.0), nb + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_pts = hz_pts / (sr / 2.0) * (bins - 1)
    fb = np.zeros((bins, nb), np.float64)
    for j in range(nb):
        lo, mid, hi = bin_pts[j], bin_pts[j + 1], bin_pts[j + 2]
        k = np.arange(bins)
        up = (k - lo) / max(mid - lo, 1e-9)
        down = (hi - k) / max(hi - mid, 1e-9)
        fb[:, j] = np.clip(np.minimum(up, down), 0.0, None)
        s = fb[:, j].sum()
        if s > 0:
            fb[:, j] /= s
    return fb


def _band_mags(x: np.ndarray) -> np.ndarray:
    """[-1,1] float signal -> [M, K_BANDS] mel-band magnitude frames."""
    n = (len(x) - FRAME) // HOP + 1
    if n <= 0:
        return np.zeros((0, K_BANDS))
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    frames = x[idx] * np.hanning(FRAME)[None, :]
    spec = np.abs(np.fft.rfft(frames, n=512, axis=-1))
    return spec @ _mel_bands(512)


def fwsnrseg(clean: np.ndarray, enhanced: np.ndarray) -> float:
    """fwSNRseg in dB of `enhanced` against `clean` (int16 or float in
    [-1, 1]); higher is better. Frames where the clean signal is silent
    (<-55 dBFS band energy) are excluded, as in the standard formulation
    (segmental measures are computed over speech-active frames)."""
    c = np.asarray(clean, np.float64)
    e = np.asarray(enhanced, np.float64)
    if np.max(np.abs(c), initial=0.0) > 4.0:
        c = c / 32768.0
    if np.max(np.abs(e), initial=0.0) > 4.0:
        e = e / 32768.0
    n = min(len(c), len(e))
    cx, ex = _band_mags(c[:n]), _band_mags(e[:n])
    if len(cx) == 0:
        return 0.0
    active = np.sqrt(np.mean(cx ** 2, axis=-1)) > 10.0 ** (-55.0 / 20.0)
    if not active.any():
        return 0.0
    cx, ex = cx[active], ex[active]
    w = cx ** GAMMA
    snr = 10.0 * np.log10(cx ** 2 / ((cx - ex) ** 2 + 1e-12) + 1e-12)
    snr = np.clip(snr, SNR_LO, SNR_HI)
    return float(np.mean(np.sum(w * snr, axis=-1) / (np.sum(w, axis=-1) + 1e-12)))


__all__ = ["fwsnrseg"]
