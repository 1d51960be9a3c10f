"""Reader of 16-bit mono WAV files, independent of the program."""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path) -> np.ndarray:
    """-> int16 samples of a mono 16-bit file."""
    with wave.open(str(path), "rb") as w:
        if w.getnchannels() != 1 or w.getsampwidth() != 2:
            raise ValueError("%s: not 16-bit mono" % path)
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).copy()
