"""16-bit mono WAV reading/writing.

The reference demos validate input WAVs strictly (16 kHz, mono, 16-bit;
reference: demo/python/koala_demo_file.py:81-88). We mirror those checks and
raise the typed error hierarchy instead of ValueError.
"""

from __future__ import annotations

import os
import wave
from typing import Optional

import numpy as np

from ..constants import SAMPLE_RATE
from ..errors import ERROR_STACK, KoalaIOError, KoalaInvalidArgumentError, raise_with_stack


def validate_wav_format(path: str, f: wave.Wave_read, expected_rate: int = SAMPLE_RATE) -> None:
    if f.getframerate() != expected_rate:
        ERROR_STACK.push("`%s` has sample rate %d, expected %d"
                         % (path, f.getframerate(), expected_rate))
        raise_with_stack(KoalaInvalidArgumentError, "Unsupported WAV format")
    if f.getnchannels() != 1:
        ERROR_STACK.push("`%s` has %d channels, expected mono" % (path, f.getnchannels()))
        raise_with_stack(KoalaInvalidArgumentError, "Unsupported WAV format")
    if f.getsampwidth() != 2:
        ERROR_STACK.push("`%s` has %d-byte samples, expected 16-bit" % (path, f.getsampwidth()))
        raise_with_stack(KoalaInvalidArgumentError, "Unsupported WAV format")


def read_wav(path: str, expected_rate: Optional[int] = SAMPLE_RATE) -> np.ndarray:
    """Read a 16-bit mono WAV into an int16 numpy array."""
    if not os.path.exists(path):
        ERROR_STACK.push("could not find WAV file at `%s`" % path)
        raise_with_stack(KoalaIOError, "IO error")
    with wave.open(path, "rb") as f:
        if expected_rate is not None:
            validate_wav_format(path, f, expected_rate)
        raw = f.readframes(f.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.int16)


def write_wav(path: str, pcm: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """Write an int16 numpy array as a 16-bit mono WAV."""
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        pcm = np.clip(np.round(pcm), -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.astype("<i2").tobytes())
