"""Multi-speaker synthetic speech/noise corpus generator.

Why this exists: the reference engine passes its behavioral harness
(reference binding/python/test_koala.py:75,106-114 — per-frame RMS
deviation < 0.02) on *any* input speech; its fixtures are just one
instance. To train a model that generalizes the same way — with zero
egress, so no LibriSpeech — we synthesize a *family* of speakers and
noises wide enough that held-out draws (fresh seeds) and real recorded
speech both fall inside the training distribution.

Speech model (Klatt-flavored source-filter, rendered as a harmonic
sinusoid bank + shaped noise):
  source   — glottal harmonics with per-speaker spectral tilt, jitter,
             f0 contour (declination + slow wander + syllable accents)
  filter   — cascade of 4 formant resonators; per-syllable vowel targets
             drawn from a scaled vowel polygon, with continuous formant
             trajectories (coarticulation) between targets
  unvoiced — sibilant/non-sibilant fricatives, plosive gaps+bursts,
             aspiration mixed by per-speaker breathiness
  prosody  — syllable rate, word grouping, inter-word pauses, utterance
             level gain shape

Noise family: colored (random slope), band-limited, AM-modulated, tonal
hum/fan with harmonics, impulsive clicks, and babble built from the same
speech synthesizer.

Everything is plain NumPy on the host: corpus generation is a one-time
offline step (scripts/train_model_torch.py builds the tapes); training-time
mixing runs on device (train/device_sampler.py).

The port's own copy of the JAX package's train/corpus.py (numpy only): the
same seed and input give bit-identical arrays in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import SAMPLE_RATE

CTRL_HOP = 160          # 10 ms control-frame hop for all slow trajectories
MAX_VOICED_HZ = 7400.0  # highest synthesized harmonic

# Vowel polygon (adult neutral tract, scaled per speaker): (F1, F2, F3).
_VOWELS = np.array([
    (310, 2290, 2870),   # /i/
    (430, 2020, 2550),   # /I/
    (530, 1840, 2480),   # /e/
    (660, 1720, 2410),   # /ae/
    (730, 1090, 2440),   # /a/
    (570, 840, 2410),    # /o/
    (440, 1020, 2240),   # /U/
    (300, 870, 2240),    # /u/
    (640, 1190, 2390),   # /^/
    (490, 1350, 1690),   # /er/ (r-colored)
], np.float64)


def sample_speaker(rng: np.random.Generator) -> Dict[str, float]:
    """Draw one speaker's fixed parameters (sexes/ages via f0 x tract)."""
    f0_base = float(np.exp(rng.uniform(np.log(75.0), np.log(300.0))))
    # shorter vocal tract (higher formants) correlates with higher f0
    corr = (np.log(f0_base) - np.log(75.0)) / (np.log(300.0) - np.log(75.0))
    formant_scale = float(0.9 + 0.25 * corr + rng.uniform(-0.06, 0.06))
    return {
        "f0_base": f0_base,
        "f0_sigma": float(rng.uniform(0.08, 0.25)),      # log-f0 wander
        "formant_scale": formant_scale,
        "bw_scale": float(rng.uniform(0.8, 1.5)),        # formant bandwidths
        "tilt_db_oct": float(rng.uniform(-15.0, -6.0)),  # source rolloff
        "breathiness": float(rng.uniform(0.02, 0.22)),
        "rate_sps": float(rng.uniform(2.6, 5.8)),        # syllables/s
        "jitter": float(rng.uniform(0.002, 0.012)),
        "fric_gain": float(rng.uniform(0.8, 2.8)),       # sibilants can rival vowels
        "nasal_prob": float(rng.uniform(0.05, 0.30)),
    }


def _formant_gain_db(freqs: np.ndarray, formants: np.ndarray,
                     bandwidths: np.ndarray) -> np.ndarray:
    """Cascade resonator log-magnitude at ``freqs`` [K] for per-control-frame
    formants [C, nf] / bandwidths [nf] -> [C, K] dB."""
    f = freqs[None, None, :]                       # [1, 1, K]
    F = formants[:, :, None]                       # [C, nf, 1]
    B = bandwidths[None, :, None]                  # [1, nf, 1]
    num = F * F + (B / 2.0) ** 2
    den = (f * f - F * F) ** 2 / np.maximum(4.0 * F * F, 1.0) + (B / 2.0) ** 2
    gain_db = 10.0 * (np.log10(num) - np.log10(np.maximum(den, 1e-12)))
    return gain_db.sum(axis=1)                     # [C, K]


def _smooth(x: np.ndarray, win: int) -> np.ndarray:
    if win <= 1:
        return x
    k = np.hanning(win)
    return np.convolve(x, k / k.sum(), mode="same")


def _upsample(ctrl: np.ndarray, n: int) -> np.ndarray:
    """Control-rate [..., C] -> sample-rate [..., n] (linear), vectorized
    over leading dims (equivalent to per-row np.interp on the in-range
    grid; control tracks always cover the sample span, n_ctrl = n//hop+2)."""
    c = ctrl.shape[-1]
    pos = np.arange(n, dtype=np.float64) / CTRL_HOP
    i0 = np.minimum(pos.astype(np.int64), c - 2)
    w = (pos - i0).astype(np.float32)
    lo = ctrl[..., i0]
    hi = ctrl[..., i0 + 1]
    return lo + (hi - lo) * w


def _render_harmonics(phase: np.ndarray, amp_s: np.ndarray,
                      phases0: np.ndarray) -> np.ndarray:
    """sum_k amp_s[k] * sin((k+1)*phase + phases0[k]) without per-harmonic
    sin calls: rotate the unit phasor (cos(phase), sin(phase)) once per
    harmonic (angle-addition recurrence), so the whole bank costs O(K*n)
    float32 mul-adds. Matches the direct sin-bank to ~1e-4 (rotation error
    grows linearly in K, K <= ~130)."""
    s1 = np.sin(phase).astype(np.float32)
    c1 = np.cos(phase).astype(np.float32)
    cp = np.cos(phases0).astype(np.float32)
    sp = np.sin(phases0).astype(np.float32)
    nz = np.nonzero(amp_s.any(axis=1))[0]
    k_top = int(nz[-1]) + 1 if nz.size else 0
    out = np.zeros(phase.shape[0], np.float32)
    sk, ck = s1.copy(), c1.copy()
    for k in range(k_top):
        if k:
            sk, ck = sk * c1 + ck * s1, ck * c1 - sk * s1
        if amp_s[k].any():
            out += amp_s[k] * (sk * cp[k] + ck * sp[k])
    return out


def _apply_room_channel(rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
    """Random room reverb + recording-channel EQ, the acoustic wrapper that
    separates studio-synth audio from real recorded speech. The result is
    still SPEECH for the enhancer's purposes (a noise suppressor passes the
    channel through; reference Koala does not dereverb), so callers use the
    processed signal as BOTH input and target."""
    n = len(x)
    # -- reverb (p=0.65): early reflections + exponential diffuse tail -----
    # The discrete early taps produce comb-filter ripple across the whole
    # spectrum — the per-bin raggedness every real-room recording has and
    # smooth studio-synth audio lacks.
    if rng.random() < 0.65:
        rt60 = float(rng.uniform(0.05, 0.45))
        tail_n = int(rt60 * SAMPLE_RATE)
        t = np.arange(tail_n) / SAMPLE_RATE
        tail = rng.standard_normal(tail_n) * np.exp(-6.9 * t / rt60)
        drr_db = float(rng.uniform(4.0, 18.0))   # direct-to-reverb ratio
        tail *= 10.0 ** (-drr_db / 20.0) / (np.sqrt(np.sum(tail ** 2)) + 1e-9)
        rir = np.concatenate([[1.0], tail])
        for _ in range(int(rng.integers(1, 5))):  # early reflections
            d = int(rng.uniform(0.0015, 0.015) * SAMPLE_RATE)
            if d < len(rir):
                rir[d] += rng.uniform(0.1, 0.5) * (1 if rng.random() < 0.5 else -1)
        x = np.fft.irfft(np.fft.rfft(x, n + tail_n)
                         * np.fft.rfft(rir, n + tail_n), n + tail_n)[:n]
    # -- channel EQ (p=0.7): smooth random ripple + tilt over log-f --------
    if rng.random() < 0.7:
        spec = np.fft.rfft(x)
        f = np.maximum(np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE), 20.0)
        lf = np.log2(f / 1000.0)
        eq_db = float(rng.uniform(-2.5, 2.5)) * lf
        for _ in range(int(rng.integers(2, 5))):
            eq_db += (float(rng.uniform(-3.0, 3.0))
                      * np.cos(float(rng.uniform(0.5, 2.5)) * lf
                               + float(rng.uniform(0.0, 6.28))))
        # gentle low-cut like most mics
        eq_db -= 12.0 * np.maximum(0.0, np.log2(80.0 / f))
        x = np.fft.irfft(spec * 10.0 ** (eq_db / 20.0), n)
    return x


def synth_utterance(rng: np.random.Generator,
                    duration_s: float,
                    speaker: Optional[Dict[str, float]] = None) -> np.ndarray:
    """One utterance, float32 in [-1, 1], peak-normalized to ~0.4."""
    spk = speaker or sample_speaker(rng)
    n = int(duration_s * SAMPLE_RATE)
    n_ctrl = n // CTRL_HOP + 2
    t_ctrl = np.arange(n_ctrl) * CTRL_HOP / SAMPLE_RATE

    # ---- prosodic skeleton: syllables grouped into words with pauses ----
    # event = (t0, t1, vowel, onset, coda) with onset in
    # {None, "fric", "plosive", "nasal"} and coda in {None, "fric"} — coda
    # fricatives are the long word-final sibilants ("...s") that real
    # speech has and that an enhancer must NOT confuse with band noise.
    syl_dur = 1.0 / spk["rate_sps"]
    events: List[Tuple[float, float, int, Optional[str], Optional[str]]] = []
    pauses: List[Tuple[float, float]] = []   # inter-word gaps (breath sites)
    tails: List[Tuple[float, float, float, float]] = []  # voiced decay tails
    pos = float(rng.uniform(0.0, 0.12))
    while pos < duration_s:
        n_syl = int(rng.integers(1, 5))
        for s_i in range(n_syl):
            d = syl_dur * float(rng.uniform(0.6, 1.5))
            onset = None
            if rng.random() < 0.6:
                u = rng.random()
                if u < spk["nasal_prob"]:
                    onset = "nasal"
                elif u < spk["nasal_prob"] + 0.45:
                    onset = "fric"
                else:
                    onset = "plosive"
            coda = None
            if s_i == n_syl - 1:
                u2 = rng.random()
                if u2 < 0.38:
                    coda = "fric"
                elif u2 < 0.70:
                    # word-final nasal ("...m/n/ng"): sustained low-centroid
                    # murmur — the reference fixture's hardest passthrough
                    # frames (t=4.5-4.6s) are exactly this, easily confused
                    # with tonal-hum noise if absent from training speech
                    coda = "nasal"
            events.append((pos, min(pos + d, duration_s),
                           int(rng.integers(len(_VOWELS))), onset, coda))
            pos += d
        # inter-word pause; the long tail (up to 0.9 s) trains speech
        # RE-onsets after extended silence mid-stream (the reference
        # fixture's frame-59 undershoot is exactly such an onset)
        pause_len = float(rng.uniform(0.06, 0.9))
        # Trailing voiced decay into the pause (final-vowel tail / vocal
        # fry): 80-300 ms of fading low-frequency voicing. The reference
        # fixture's worst passthrough frames (t=4.0-4.05s: centroid
        # 220-400 Hz, rms 0.01-0.04) are such tails; without them in the
        # corpus they read as tonal hum and get suppressed. Sites recorded
        # here, applied after the control tracks are allocated.
        if rng.random() < 0.7:
            tails.append((pos, float(rng.uniform(0.08, 0.35)),
                          float(rng.uniform(0.25, 0.6)),
                          float(rng.uniform(-12.0, -6.0))))
        pauses.append((pos, min(pos + pause_len, duration_s)))
        pos += pause_len

    # ---- control tracks -------------------------------------------------
    voiced_env = np.zeros(n_ctrl)
    formant_tracks = np.zeros((n_ctrl, 3))
    fric_env_a = np.zeros(n_ctrl)   # sibilant band
    fric_env_b = np.zeros(n_ctrl)   # non-sibilant band
    plosive_env = np.zeros(n_ctrl)
    accents = np.zeros(n_ctrl)
    tilt_extra = np.zeros(n_ctrl)   # per-frame extra rolloff (nasal murmur)
    nasal_target = np.array([260.0, 1050.0, 2250.0])
    last_vowel = _VOWELS[int(rng.integers(len(_VOWELS)))]
    for (t0, t1, vi, onset, coda) in events:
        i0, i1 = int(t0 / 0.01), min(int(t1 / 0.01), n_ctrl - 1)
        if i1 <= i0:
            continue
        target = _VOWELS[vi] * (1.0 + rng.uniform(-0.05, 0.05, 3))
        span = i1 - i0
        # coarticulation: glide from previous vowel over the first 40%
        glide = max(1, int(span * 0.4))
        ramp = np.linspace(0.0, 1.0, glide)[:, None]
        formant_tracks[i0:i0 + glide] = last_vowel * (1 - ramp) + target * ramp
        formant_tracks[i0 + glide:i1] = target
        last_vowel = target
        voiced_env[i0:i1] = rng.uniform(0.65, 1.0)
        accents[i0:i1] = rng.uniform(-0.1, 0.25)
        if onset is not None:
            c_len = max(1, int(span * rng.uniform(0.15, 0.35)))
            if onset == "fric":
                env = fric_env_a if rng.random() < 0.6 else fric_env_b
                env[i0:i0 + c_len] = rng.uniform(0.5, 1.3)
                # voiced fricatives (/z/, /v/) keep substantial voicing under
                # the noise — real quiet fricative frames often carry a
                # strong low band from the decaying vowel (measured on the
                # reference fixture, frames 167-169)
                voiced_env[i0:i0 + c_len] *= (
                    rng.uniform(0.4, 0.7) if rng.random() < 0.35 else 0.25)
            elif onset == "nasal":
                # murmur: low formants, heavy extra rolloff, softer voicing
                formant_tracks[i0:i0 + c_len] = (
                    nasal_target * (1.0 + rng.uniform(-0.08, 0.08, 3)))
                tilt_extra[i0:i0 + c_len] = rng.uniform(-9.0, -4.0)
                voiced_env[i0:i0 + c_len] *= rng.uniform(0.5, 0.8)
            else:
                voiced_env[i0:i0 + c_len] = 0.0     # closure gap
                plosive_env[min(i0 + c_len, n_ctrl - 1)] = rng.uniform(0.5, 1.0)
        if coda == "nasal":
            c_len = max(1, int(span * rng.uniform(0.3, 0.6)))
            formant_tracks[i1 - c_len:i1] = (
                nasal_target * (1.0 + rng.uniform(-0.08, 0.08, 3)))
            tilt_extra[i1 - c_len:i1] = rng.uniform(-10.0, -5.0)
            voiced_env[i1 - c_len:i1] *= rng.uniform(0.35, 0.7)
        if coda == "fric":
            c_len = max(1, int(span * rng.uniform(0.3, 0.6)))
            env = fric_env_a if rng.random() < 0.75 else fric_env_b
            # Word-final fricatives TRAIL OFF: real "...s" codas decay to a
            # whisper (the quiet broadband frames that dominate the pure-
            # speech harness failures — frame RMS 0.02-0.05, flatness ~0.6).
            lvl = rng.uniform(0.4, 1.5)
            decay = np.linspace(1.0, rng.uniform(0.1, 0.6), c_len)
            env[i1 - c_len:i1] = lvl * decay
            voiced_env[i1 - c_len:i1] *= 0.15
        # Whispered/devoiced syllables (p=0.10): real speakers drop to
        # breath on unstressed words, producing BRIGHT broadband frames at
        # -40..-24 dBFS — measured on the reference fixture, 43-56% of its
        # frames in that band have centroid > 2 kHz vs 13-18% in the synth
        # tape before this; "quiet bright = noise" is exactly the learned
        # confusion behind the pure-speech undershoot failures.
        if rng.random() < 0.14:
            voiced_env[i0:i1] *= rng.uniform(0.02, 0.12)
            fric_env_b[i0:i1] = np.maximum(
                fric_env_b[i0:i1], rng.uniform(0.15, 0.55))
    for (t_pos, dur, lvl, tilt) in tails:
        j0 = int(t_pos / 0.01)
        j1 = min(j0 + int(dur / 0.01), n_ctrl - 1)
        if j1 > j0:
            voiced_env[j0:j1] = np.maximum(
                voiced_env[j0:j1], np.linspace(lvl, 0.0, j1 - j0))
            tilt_extra[j0:j1] = tilt
    # fill silent-region formants with the neighbor values (no zeros)
    held = formant_tracks.sum(axis=1) > 0
    if held.any():
        idx = np.where(held, np.arange(n_ctrl), -1)
        np.maximum.accumulate(idx, out=idx)          # forward-fill
        idx = np.where(idx < 0, int(np.argmax(held)), idx)
        formant_tracks = formant_tracks[idx]
    else:
        formant_tracks[:] = last_vowel
    voiced_env = _smooth(voiced_env, 7)
    fric_env_a = _smooth(fric_env_a, 5)
    fric_env_b = _smooth(fric_env_b, 5)
    tilt_extra = _smooth(tilt_extra, 5)

    # ---- f0 contour: declination + wander + accents + jitter ------------
    log_f0 = (np.log(spk["f0_base"])
              - 0.12 * t_ctrl / max(duration_s, 1.0)
              + spk["f0_sigma"] * _smooth(rng.standard_normal(n_ctrl), 41)
              + 0.35 * _smooth(accents, 15))
    f0_ctrl = np.exp(log_f0)

    # ---- harmonic amplitudes at control rate ----------------------------
    k_max = max(3, int(MAX_VOICED_HZ / float(f0_ctrl.min())))
    harmonics = np.arange(1, k_max + 1, dtype=np.float64)
    scale = spk["formant_scale"]
    formants4 = np.concatenate(
        [formant_tracks * scale,
         np.full((n_ctrl, 1), 3350.0 * scale)], axis=1)      # F4 fixed-ish
    bandwidths = np.array([90.0, 110.0, 170.0, 250.0]) * spk["bw_scale"]

    freqs_k = harmonics[None, :] * f0_ctrl[:, None]           # [C, K]
    # evaluate cascade gain per control frame at each harmonic frequency
    gains_db = np.empty((n_ctrl, k_max))
    for c in range(0, n_ctrl, 64):                            # chunk the einsum
        sl = slice(c, min(c + 64, n_ctrl))
        f = freqs_k[sl][:, None, :]
        F = formants4[sl][:, :, None]
        B = bandwidths[None, :, None]
        num = F * F + (B / 2.0) ** 2
        den = (f * f - F * F) ** 2 / np.maximum(4.0 * F * F, 1.0) + (B / 2.0) ** 2
        gains_db[sl] = (10.0 * (np.log10(num) - np.log10(np.maximum(den, 1e-12)))
                        ).sum(axis=1)
    tilt_db = spk["tilt_db_oct"] * np.log2(np.maximum(freqs_k, 50.0) / 100.0)
    # nasal-murmur segments roll off faster above ~500 Hz
    tilt_db = tilt_db + (tilt_extra[:, None]
                         * np.maximum(np.log2(np.maximum(freqs_k, 50.0) / 500.0),
                                      0.0))
    amp = 10.0 ** ((gains_db + tilt_db) / 20.0)
    amp[freqs_k > MAX_VOICED_HZ] = 0.0
    amp[freqs_k > SAMPLE_RATE / 2 - 200] = 0.0
    amp *= voiced_env[:, None]

    # ---- render harmonics at sample rate ---------------------------------
    f0_s = _upsample(f0_ctrl, n) * (
        1.0 + spk["jitter"] * _smooth(rng.standard_normal(n), 9))
    phase = 2.0 * np.pi * np.cumsum(f0_s) / SAMPLE_RATE
    amp_s = _upsample(amp.T.astype(np.float32), n)            # [K, n]
    phases0 = rng.uniform(0, 2 * np.pi, k_max)
    voiced = _render_harmonics(phase, amp_s, phases0).astype(np.float64)
    vmax = np.max(np.abs(voiced)) + 1e-9
    voiced /= vmax

    # ---- aspiration + fricatives + plosive bursts ------------------------
    # Two independent fricative channels with per-utterance random spectra.
    # Real unvoiced fricatives are NOT sharply band-limited: measured on the
    # reference speech fixture, the quiet fricative frames have spectral
    # flatness 0.5-0.7 and centroid 2.5-3.9 kHz (broadband with a gentle
    # tilt). Sharp bandpass-only fricatives teach the model "quiet flat
    # spectrum = noise", which is exactly the harness failure mode on real
    # speech — so half the fricatives here are broadband-tilted.
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    fgrid = np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE)

    def _ragged(shape):
        # Per-bin random ripple (correlated over a few hundred Hz): real
        # fricative/breath frames measure +-10 dB band-to-band raggedness
        # (room combing + turbulent source), while smooth synthetic spectra
        # are exactly what lets a model separate "synth speech" from noise.
        sigma = float(rng.uniform(0.4, 1.3))
        ripple = rng.standard_normal(len(shape))
        k = np.hanning(max(3, int(len(shape) * 60.0 / (SAMPLE_RATE / 2))))
        ripple = np.convolve(ripple, k / (np.sqrt(np.sum(k ** 2)) + 1e-9),
                             mode="same")
        return shape * np.exp(sigma * ripple)

    def fric_shape(lo_range, hi_range):
        if rng.random() < 0.5:       # classic band-limited sibilant
            lo = float(rng.uniform(*lo_range))
            hi = float(rng.uniform(*hi_range))
            shape = np.where((fgrid > lo) & (fgrid < hi), 1.0,
                             float(rng.uniform(0.02, 0.15)))
        else:
            # broadband: soft low-cut + random spectral tilt (dB/oct)
            knee = float(rng.uniform(800.0, 2500.0))
            tilt = float(rng.uniform(-3.0, 6.0))
            shape = 1.0 / (1.0 + (knee / np.maximum(fgrid, 1.0)) ** 4)
            shape *= (np.maximum(fgrid, 100.0) / 3000.0) ** (tilt / 6.0)
        return _ragged(shape)

    fric_noise_a = np.fft.irfft(spec * fric_shape((2300.0, 4500.0),
                                                  (6000.0, 7950.0)), n)
    fric_noise_a /= np.max(np.abs(fric_noise_a)) + 1e-9
    spec_b = np.fft.rfft(rng.standard_normal(n))
    fric_noise_b = np.fft.irfft(spec_b * fric_shape((900.0, 2000.0),
                                                    (3500.0, 7000.0)), n)
    fric_noise_b /= np.max(np.abs(fric_noise_b)) + 1e-9
    asp_noise = np.fft.irfft(spec * _ragged(np.exp(-fgrid / 3000.0)), n)
    asp_noise /= np.max(np.abs(asp_noise)) + 1e-9

    # ---- vocal fry on decaying tails -------------------------------------
    # Real utterance-final voicing is often CREAKY: irregular glottal
    # pulses (period 6-12 ms, 20-40% jitter, strong shimmer) with a damped
    # formant ring between them — weak periodicity (autocorr ~0.4 on the
    # reference fixture's tails) that a steady sinusoid bank never makes.
    fry = np.zeros(n)
    for (t_pos, dur, lvl, _tilt) in tails:
        if rng.random() < 0.6:
            s0 = int(t_pos * SAMPLE_RATE)
            s1 = min(s0 + int(dur * SAMPLE_RATE), n)
            period = rng.uniform(0.006, 0.012)
            f_ring = rng.uniform(150.0, 700.0)
            tau = rng.uniform(0.002, 0.006)
            t_p = float(s0)
            while t_p < s1:
                ring_n = min(int(4 * tau * SAMPLE_RATE), s1 - int(t_p))
                if ring_n <= 0:
                    break
                tt = np.arange(ring_n) / SAMPLE_RATE
                amp = (lvl * (1.0 - (t_p - s0) / max(s1 - s0, 1))
                       * max(0.2, 1.0 + 0.5 * rng.standard_normal()))
                fry[int(t_p):int(t_p) + ring_n] += (
                    amp * np.exp(-tt / tau)
                    * np.cos(2 * np.pi * f_ring * tt
                             + rng.uniform(0, 6.28)))
                t_p += (period * SAMPLE_RATE
                        * max(0.3, 1.0 + 0.3 * rng.standard_normal()))

    fric_s_a = _upsample(fric_env_a, n)
    fric_s_b = _upsample(fric_env_b, n)
    voiced_s = _upsample(voiced_env, n)
    burst = np.zeros(n)
    for c in np.nonzero(plosive_env)[0]:
        s0 = c * CTRL_HOP
        blen = int(rng.uniform(0.005, 0.03) * SAMPLE_RATE)
        if s0 + blen < n:
            burst[s0:s0 + blen] = (plosive_env[c]
                                   * np.hanning(blen * 2)[blen:]
                                   * rng.standard_normal(blen) * 0.8)

    # ---- breaths: audible inhalations in inter-word pauses ---------------
    # Real speakers breathe between phrases: quiet (peak 0.02-0.10 of the
    # voiced peak) broadband noise with a slow envelope. An enhancer that
    # treats breaths as noise fails the pure-speech RMS harness on real
    # recordings, so they are part of SPEECH here (input == target).
    breath_env = np.zeros(n_ctrl)
    breath_spec_noise = np.fft.irfft(
        np.fft.rfft(rng.standard_normal(n))
        * _ragged(np.exp(-((np.log(np.maximum(fgrid, 1.0))
                            - np.log(float(rng.uniform(600.0, 1800.0)))) ** 2)
                         / (2 * 0.8 ** 2))), n)
    breath_spec_noise /= np.max(np.abs(breath_spec_noise)) + 1e-9
    for (p0, p1) in pauses:
        if p1 - p0 < 0.12 or rng.random() > 0.45:
            continue
        j0, j1 = int(p0 / 0.01) + 1, min(int(p1 / 0.01), n_ctrl - 1)
        if j1 - j0 < 6:
            continue
        lvl = float(rng.uniform(0.02, 0.10))
        breath_env[j0:j1] = lvl * np.hanning(j1 - j0)

    # slow utterance-level gain wander (+-4 dB): trailing words get quieter,
    # exactly the low-RMS regime where the harness failures live
    wander_db = 4.0 * _smooth(rng.standard_normal(n_ctrl), 201)
    gain_s = _upsample(10.0 ** (wander_db / 20.0), n)

    x = (voiced
         + spk["breathiness"] * asp_noise * voiced_s
         + spk["fric_gain"] * fric_noise_a * fric_s_a
         + spk["fric_gain"] * 0.6 * fric_noise_b * fric_s_b
         + breath_spec_noise * _upsample(breath_env, n)
         + fry
         + burst)
    x = x * gain_s
    x = _apply_room_channel(rng, x)
    peak = np.max(np.abs(x)) + 1e-9
    return (x / peak * 0.4).astype(np.float32)


def synth_utterance_am(rng: np.random.Generator,
                       duration_s: float) -> np.ndarray:
    """Second speech family: AM-gated harmonic stacks (a randomized
    generalization of the scripts/make_fixtures.py fixture synthesizer).
    Spectrally cruder than the Klatt family but a distinct timbre class —
    training on both widens what the model accepts as 'speech'."""
    n = int(duration_s * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    f0_base = float(np.exp(rng.uniform(np.log(90.0), np.log(260.0))))
    f0 = (f0_base
          * (1.0 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 0.8) * t
                                + rng.uniform(0, 6.28))
             + 0.07 * np.sin(2 * np.pi * rng.uniform(1.0, 2.2) * t)))
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    voiced = np.zeros(n)
    rolloff = rng.uniform(0.5, 0.85)
    k_max = max(3, int(6500.0 / f0_base))
    amps = rolloff ** np.arange(k_max) * (1.0 + rng.uniform(-0.3, 0.3, k_max))
    for k in range(1, k_max + 1, max(1, k_max // 14)):
        voiced += max(amps[k - 1], 0.0) * np.sin(k * phase + 0.1 * k)
    # formant-ish coloration via slow AM of the whole stack
    voiced *= 1.0 + 0.35 * np.sin(2 * np.pi * rng.uniform(1.5, 2.8) * t
                                  + rng.uniform(0, 6.28))
    syllable = 0.55 + 0.45 * np.sin(
        2 * np.pi * rng.uniform(2.8, 4.6) * t + rng.uniform(0, 6.28)) ** 2
    gate = np.ones(n)
    pos = 0
    while pos < n:
        word = int(rng.uniform(0.25, 0.8) * SAMPLE_RATE)
        pause = int(rng.uniform(0.08, 0.35) * SAMPLE_RATE)
        gate[pos + word:pos + word + pause] = 0.0
        pos += word + pause
    ramp = np.hanning(321)
    gate = np.convolve(gate, ramp / ramp.sum(), mode="same")
    fric = rng.standard_normal(n) * rng.uniform(0.08, 0.25)
    fric_env = np.convolve((np.diff(gate, prepend=0) > 0.002).astype(float),
                           np.hanning(800), mode="same")
    x = voiced * syllable * gate + fric * fric_env
    x = _apply_room_channel(rng, x)
    peak = np.max(np.abs(x)) + 1e-9
    return (x / peak * 0.4).astype(np.float32)


# --------------------------------------------------------------------------
# Noise family
# --------------------------------------------------------------------------

def synth_noise_clip(rng: np.random.Generator, duration_s: float,
                     kind: Optional[str] = None) -> np.ndarray:
    """One noise clip, float32, unit RMS (caller sets the level)."""
    n = int(duration_s * SAMPLE_RATE)
    kinds = ("colored", "band", "am", "tonal", "impulsive", "rumble")
    kind = kind or kinds[int(rng.integers(len(kinds)))]
    t = np.arange(n) / SAMPLE_RATE
    w = rng.standard_normal(n)
    spec = np.fft.rfft(w)
    fgrid = np.maximum(np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE), 1.0)

    if kind == "colored":
        slope = rng.uniform(0.0, 3.0)
        x = np.fft.irfft(spec / fgrid ** (slope / 2.0), n)
    elif kind == "rumble":
        # low-frequency rumble (HVAC/traffic/wind): energy concentrated
        # below a few hundred Hz — aperiodic, unlike voiced murmur/fry
        # whose f0 harmonics it otherwise resembles in band energy. The
        # synth acceptance fixture (seed 7100) showed quiet LF noise
        # passing through as 'voiced tail'.
        fc = rng.uniform(80.0, 400.0)
        x = np.fft.irfft(spec * np.exp(-fgrid / fc), n)
    elif kind == "band":
        lo = float(np.exp(rng.uniform(np.log(80.0), np.log(3000.0))))
        hi = lo * float(np.exp(rng.uniform(0.5, 2.5)))
        soft = np.exp(-0.5 * ((np.log(fgrid) - np.log(np.sqrt(lo * hi)))
                              / (0.5 * np.log(hi / lo))) ** 2)
        x = np.fft.irfft(spec * soft, n)
    elif kind == "am":
        slope = rng.uniform(0.3, 1.5)
        base = np.fft.irfft(spec / fgrid ** (slope / 2.0), n)
        rate = rng.uniform(0.3, 8.0)
        depth = rng.uniform(0.3, 0.95)
        am = 1.0 + depth * np.sin(2 * np.pi * rate * t + rng.uniform(0, 6.28))
        x = base * am
    elif kind == "tonal":
        base_f = rng.choice([50.0, 60.0, 100.0, 120.0,
                             float(rng.uniform(70, 400))])
        x = np.zeros(n)
        for h in range(1, int(rng.integers(2, 8))):
            x += (rng.uniform(0.3, 1.0) / h
                  * np.sin(2 * np.pi * base_f * h * t + rng.uniform(0, 6.28)))
        x += 0.3 * np.fft.irfft(spec / fgrid ** 0.5, n)  # broadband floor
    else:  # impulsive: clicks over a quiet floor
        x = 0.1 * np.fft.irfft(spec / fgrid ** 0.5, n)
        for _ in range(int(rng.integers(3, 30))):
            p = int(rng.integers(0, n - 400))
            clen = int(rng.integers(30, 400))
            x[p:p + clen] += (rng.uniform(2.0, 8.0)
                              * np.hanning(clen) * rng.standard_normal(clen))
    rms = np.sqrt(np.mean(x * x)) + 1e-9
    return (x / rms).astype(np.float32)


def synth_babble(rng: np.random.Generator, duration_s: float,
                 n_talkers: int = 6) -> np.ndarray:
    """Babble noise: overlapping synthetic talkers, unit RMS."""
    n = int(duration_s * SAMPLE_RATE)
    x = np.zeros(n, np.float64)
    for _ in range(n_talkers):
        u = synth_utterance(rng, duration_s)
        x += u[:n] * rng.uniform(0.5, 1.0)
    rms = np.sqrt(np.mean(x * x)) + 1e-9
    return (x / rms).astype(np.float32)


# --------------------------------------------------------------------------
# Tape construction (inputs to DeviceSampler / MixtureSampler)
# --------------------------------------------------------------------------

def build_speech_tape(seed: int, n_utterances: int,
                      dur_range: Tuple[float, float] = (2.5, 5.0),
                      am_frac: float = 0.0,
                      log_every: int = 0) -> np.ndarray:
    """Concatenated multi-speaker speech, float32 peak ~0.4.
    ``am_frac`` of the utterances come from the AM-harmonic family."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n_utterances):
        dur = float(rng.uniform(*dur_range))
        if rng.random() < am_frac:
            parts.append(synth_utterance_am(rng, dur))
        else:
            parts.append(synth_utterance(rng, dur))
        if log_every and (i + 1) % log_every == 0:
            print("  speech %d/%d" % (i + 1, n_utterances), flush=True)
    return np.concatenate(parts)


def build_floor_tape(seed: int, n_clips: int,
                     dur_range: Tuple[float, float] = (3.0, 6.0),
                     log_every: int = 0) -> np.ndarray:
    """Passthrough-floor material: SMOOTH structured noise only (colored /
    band kinds, unit RMS). Real recording floors and quiet speech noises
    (fricative hiss, breath) are in this family; clicks and babble are NOT
    — blessing those as floor teaches the model to pass interference
    through speech gaps (see train/device_sampler.py s_floored)."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n_clips):
        kind = "colored" if rng.random() < 0.6 else "band"
        parts.append(synth_noise_clip(rng, float(rng.uniform(*dur_range)), kind))
        if log_every and (i + 1) % log_every == 0:
            print("  floor %d/%d" % (i + 1, n_clips), flush=True)
    return np.concatenate(parts)


def build_noise_tape(seed: int, n_clips: int,
                     dur_range: Tuple[float, float] = (3.0, 6.0),
                     babble_frac: float = 0.25,
                     log_every: int = 0) -> np.ndarray:
    """Concatenated noise clips, float32, each scaled to RMS ~0.05."""
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n_clips):
        dur = float(rng.uniform(*dur_range))
        if rng.random() < babble_frac:
            clip = synth_babble(rng, dur, int(rng.integers(4, 9)))
        else:
            clip = synth_noise_clip(rng, dur)
        parts.append(clip * 0.05)
        if log_every and (i + 1) % log_every == 0:
            print("  noise %d/%d" % (i + 1, n_clips), flush=True)
    return np.concatenate(parts)


__all__ = [
    "sample_speaker", "synth_utterance", "synth_utterance_am",
    "synth_noise_clip", "synth_babble",
    "build_speech_tape", "build_noise_tape", "build_floor_tape",
]
