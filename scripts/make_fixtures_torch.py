"""Generate the repository's own audio fixtures with the PyTorch/CUDA
package's numpy corpus synthesiser.

Usage:
    python scripts/make_fixtures_torch.py

The counterpart of ``scripts/make_fixtures.py`` for a machine without JAX:
the same seeds and calibration, the same file names and the same bytes. It
writes ``speech_synth.wav`` (Klatt-family speech, seed 7000) and
``noise_synth.wav`` (a colored-noise clip, seed 7100) into ``OUT_DIR``,
``resources/audio_samples/``, overwriting what is there: the synthesiser has
changed since the committed fixtures were written, so running it against the
repository rewrites them with different audio. The seeds never appear in the
training tapes or the dev battery.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from koala_tpu_torch.constants import SAMPLE_RATE
from koala_tpu_torch.io import write_wav

DURATION_S = 5.855
N = int(DURATION_S * SAMPLE_RATE)

SPEECH_SEED = 7000   # disjoint from train (100/200) and dev battery (9xxx)
NOISE_SEED = 7100

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "resources", "audio_samples")


def synth_speech(rng: np.random.Generator) -> np.ndarray:
    from koala_tpu_torch.train.corpus import build_speech_tape

    x = build_speech_tape(SPEECH_SEED, 2, dur_range=(3.0, 3.2))[:N]
    return np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)


def synth_noise(rng: np.random.Generator) -> np.ndarray:
    from koala_tpu_torch.train.corpus import synth_noise_clip

    # the dev battery's calibration (scripts/make_corpus_torch.py): overall
    # RMS 0.023, loudest frame 0.06
    x = synth_noise_clip(np.random.default_rng(NOISE_SEED),
                         DURATION_S, "colored") * 0.023
    fr = x[:len(x) // 256 * 256].reshape(-1, 256)
    worst = float(np.sqrt((fr * fr).mean(axis=1)).max())
    if worst > 0.06:
        x = x * (0.06 / worst)
    return np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    rng = np.random.default_rng(20260817)
    write_wav(os.path.join(OUT_DIR, "speech_synth.wav"), synth_speech(rng))
    write_wav(os.path.join(OUT_DIR, "noise_synth.wav"), synth_noise(rng))
    print("wrote fixtures to", OUT_DIR)


if __name__ == "__main__":
    main()
