"""Traffic audio: mixes of the committed speech and noise recordings.

Every input of every cell is a mix of one of the 8 speech and one of the 8
noise recordings in `resources/audio_samples/` (16 kHz, 16-bit, about 5.9 s
each), each read from a seeded circular offset, so a mix of any length
loops its sources. The speech is set to a level (dBFS RMS) and the noise
under it to an SNR (dB). A seed draws the sources and offsets, and deals
each mix its SNR and level from grids that are the same for every seed
(only their order differs), so that every seed gives the program the same
amount and kind of work. Mixes are built on the device in a few large
gathers.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .reference.wav import read_wav

AUDIO_DIR = os.path.join("resources", "audio_samples")
PCM_SCALE = 32768.0


class Bank:
    """The speech and noise recordings on a device, each at unit RMS."""

    def __init__(self, root, device):
        folder = os.path.join(root, AUDIO_DIR)
        names = sorted(os.listdir(folder))

        def load(prefix):
            clips = [read_wav(os.path.join(folder, n)).astype(np.float32) / PCM_SCALE
                     for n in names if n.startswith(prefix) and n.endswith(".wav")]
            if len(clips) != 8:
                raise RuntimeError("%s: expected 8 %s*.wav, found %d"
                                   % (folder, prefix, len(clips)))
            n = min(len(c) for c in clips)
            a = np.stack([c[:n] for c in clips])
            a /= np.sqrt(np.mean(a * a, axis=1, keepdims=True))
            return torch.as_tensor(a, device=device)

        self.speech = load("speech_")
        self.noise = load("noise_")
        self.length = min(self.speech.shape[1], self.noise.shape[1])
        self.device = device


class Plan:
    """The per-mix draws of `n` mixes from a generator: sources, offsets,
    and SNR and level dealt from fixed grids."""

    def __init__(self, rng: np.random.Generator, n: int, length: int,
                 snr_db=(-5.0, 20.0), level_db=(-38.0, -22.0)):
        self.speech = rng.integers(0, 8, n)
        self.noise = rng.integers(0, 8, n)
        self.speech_off = rng.integers(0, length, n)
        self.noise_off = rng.integers(0, length, n)
        self.snr_db = rng.permutation(np.linspace(snr_db[0], snr_db[1], n))
        self.level_db = rng.permutation(np.linspace(level_db[0], level_db[1], n))


def mix(bank: Bank, plan: Plan, rows, samples: int, start: int = 0) -> torch.Tensor:
    """float32 [len(rows), samples] on the bank's device: samples
    [start, start + samples) of the mixes `rows` of `plan`, clipped to the
    int16 range."""
    rows = np.asarray(rows)
    dev = bank.device
    t = torch.arange(start, start + samples, device=dev)

    def take(src, which, off):
        idx = (torch.as_tensor(off[rows], device=dev)[:, None] + t[None, :]) % bank.length
        return src[torch.as_tensor(which[rows], device=dev)[:, None], idx]

    level = torch.as_tensor(10.0 ** (plan.level_db[rows] / 20.0), dtype=torch.float32, device=dev)
    snr = torch.as_tensor(10.0 ** (-plan.snr_db[rows] / 20.0), dtype=torch.float32, device=dev)
    x = (take(bank.speech, plan.speech, plan.speech_off)
         + snr[:, None] * take(bank.noise, plan.noise, plan.noise_off)) * level[:, None]
    return x.clamp_(-1.0, 32767.0 / PCM_SCALE)


def mix_blocks(bank: Bank, plan: Plan, samples: int, block: int = 256) -> torch.Tensor:
    """All mixes of `plan`, [n, samples] float32 on the device, in blocks of rows."""
    n = len(plan.snr_db)
    out = torch.empty((n, samples), dtype=torch.float32, device=bank.device)
    for lo in range(0, n, block):
        out[lo:lo + block] = mix(bank, plan, np.arange(lo, min(n, lo + block)), samples)
    return out
