"""STOI — Short-Time Objective Intelligibility (Taal et al., ICASSP 2010).

The intelligibility-parity metric next to SI-SDR (BASELINE.json asks for
"SI-SDR/PESQ parity"; PESQ itself is an ITU-T P.862 licensed algorithm, so
we gate on STOI — the standard open alternative with the same role: a
perceptual score of the enhanced signal against the clean reference).

Classic (non-extended) STOI, from the published definition:
  1. resample both signals to 10 kHz,
  2. remove silent frames (energy > 40 dB below the loudest frame, computed
     on the CLEAN signal, applied to both),
  3. 256-sample Hann frames, 50% overlap, 512-point FFT,
  4. 15 one-third-octave bands, 150 Hz .. ~4.3 kHz,
  5. short-time (N=30 frames, 384 ms) band envelopes; the degraded envelope
     is scaled to the clean one's norm and clipped at -beta = -15 dB SDR,
  6. score = mean over bands/segments of the envelope correlation.

Pure NumPy, host-side (evaluation only — never on the device hot path).
Scores are in [~0, 1]; > 0.92 on the enhanced mix ~= "intelligible".

The port's own copy of the JAX package's train/stoi.py (numpy only): the
same seed and input give bit-identical arrays in both packages.
"""

from __future__ import annotations

import numpy as np

FS = 10000           # STOI operating rate
FRAME = 256          # analysis window at 10 kHz (25.6 ms)
HOP = 128
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0     # center of the lowest one-third-octave band
SEG_FRAMES = 30      # short-time segment length (384 ms)
BETA_DB = -15.0      # SDR clip
DYN_RANGE_DB = 40.0  # silent-frame threshold


def _resample(x: np.ndarray, fs_in: int, fs_out: int = FS) -> np.ndarray:
    """FFT-domain resampling (exact band truncation/zero-pad)."""
    if fs_in == fs_out:
        return np.asarray(x, np.float64)
    x = np.asarray(x, np.float64)
    n_out = int(round(len(x) * fs_out / fs_in))
    spec = np.fft.rfft(x)
    k_out = n_out // 2 + 1
    out_spec = np.zeros(k_out, complex)
    k = min(k_out, len(spec))
    out_spec[:k] = spec[:k]
    return np.fft.irfft(out_spec, n_out) * (n_out / len(x))


def _third_octave_bands(nfft: int = NFFT, fs: int = FS,
                        num_bands: int = NUM_BANDS,
                        min_freq: float = MIN_FREQ) -> np.ndarray:
    """[num_bands, nfft//2+1] 0/1 matrix selecting each band's FFT bins."""
    f = np.linspace(0.0, fs / 2.0, nfft // 2 + 1)
    k = np.arange(num_bands, dtype=np.float64)
    cf = (2.0 ** (k / 3.0)) * min_freq
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    bands = np.zeros((num_bands, len(f)))
    for b in range(num_bands):
        # each bin assigned by nearest-edge rule of the published impl
        i_lo = int(np.argmin((f - lo[b]) ** 2))
        i_hi = int(np.argmin((f - hi[b]) ** 2))
        bands[b, i_lo:i_hi] = 1.0
    return bands


def _frames(x: np.ndarray) -> np.ndarray:
    """[n_frames, FRAME] Hann-windowed frames, 50% overlap."""
    n = (len(x) - FRAME) // HOP + 1
    if n <= 0:
        return np.zeros((0, FRAME))
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx] * np.hanning(FRAME)[None, :]


def stoi(clean: np.ndarray, degraded: np.ndarray, fs: int = 16000) -> float:
    """STOI score of ``degraded`` against ``clean`` (both 1-D, any common
    sample rate). int16 or float accepted. Returns a float in [~0, 1];
    NaN-free even for silent inputs (returns 0.0 when nothing survives the
    silence gate)."""
    clean = np.asarray(clean, np.float64)
    degraded = np.asarray(degraded, np.float64)
    n = min(len(clean), len(degraded))
    clean, degraded = clean[:n], degraded[:n]

    x = _resample(clean, fs)
    y = _resample(degraded, fs)

    xf = _frames(x)
    yf = _frames(y)
    if len(xf) < SEG_FRAMES:
        return 0.0

    # silent-frame removal driven by the clean signal
    energy_db = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = energy_db > (energy_db.max() - DYN_RANGE_DB)
    xf, yf = xf[keep], yf[keep]
    if len(xf) < SEG_FRAMES:
        return 0.0

    bands = _third_octave_bands()
    # band envelopes: sqrt of band-summed power per frame -> [frames, bands]
    xs = np.abs(np.fft.rfft(xf, NFFT)) ** 2
    ys = np.abs(np.fft.rfft(yf, NFFT)) ** 2
    xe = np.sqrt(xs @ bands.T + 1e-12)
    ye = np.sqrt(ys @ bands.T + 1e-12)

    clip = 10.0 ** (-BETA_DB / 20.0)
    n_seg = len(xe) - SEG_FRAMES + 1
    scores = np.empty((n_seg, NUM_BANDS))
    for m in range(n_seg):
        xm = xe[m:m + SEG_FRAMES]                       # [N, J]
        ym = ye[m:m + SEG_FRAMES]
        alpha = (np.linalg.norm(xm, axis=0)
                 / (np.linalg.norm(ym, axis=0) + 1e-12))
        ym = np.minimum(ym * alpha[None, :], (1.0 + clip) * xm)
        xm = xm - xm.mean(axis=0, keepdims=True)
        ym = ym - ym.mean(axis=0, keepdims=True)
        num = (xm * ym).sum(axis=0)
        den = (np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12)
        scores[m] = num / den
    return float(scores.mean())


__all__ = ["stoi"]
