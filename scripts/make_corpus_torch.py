"""Build the synthetic training corpus tapes and the held-out dev fixtures
with the PyTorch/CUDA package's numpy corpus synthesiser.

Usage:
    python scripts/make_corpus_torch.py [--speech-utts 600] [--noise-clips 300] [--force]

The counterpart of ``scripts/make_corpus.py`` for a machine without JAX: the
same seeds, battery, flags, calibration and file names, and the same bytes in
every file it writes (``koala_tpu_torch.train.corpus`` gives the JAX
package's arrays bit for bit). It imports only numpy and the port's corpus
and WAV modules.

Training tapes (``CORPUS_DIR``, ``resources/corpus/*.npy``, gitignored):
multi-speaker synthetic speech, wide-family noise and floor noise. Dev
fixtures (``SAMPLES_DIR``, ``resources/audio_samples/speech_dev*.wav`` /
``noise_dev*.wav``, committed): fresh-seed draws from the same family, the
held-out battery of the acceptance gates. An existing file is kept unless
``--force`` is given. The synthesiser has changed since the committed WAVs
were written, so ``--force`` against the repository rewrites them with
different audio.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

TRAIN_SPEECH_SEED = 100
TRAIN_NOISE_SEED = 200
TRAIN_FLOOR_SEED = 300
DEV_SPEECH_SEED = 9100
DEV_NOISE_SEED = 9200

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_DIR = os.path.join(REPO, "resources", "corpus")
SAMPLES_DIR = os.path.join(REPO, "resources", "audio_samples")

DEV_SECONDS = 5.855          # the reference fixtures' length: 93680 samples
# The reference noise.wav's profile (overall RMS 0.0232, loudest frame 0.052):
# the battery keeps the reference's difficulty and widens the noise kinds.
NOISE_RMS, MAX_FRAME_RMS = 0.023, 0.06


def build_training_tapes(n_speech: int, n_noise: int, force: bool = False):
    from koala_tpu_torch.train.corpus import (build_floor_tape, build_noise_tape,
                                              build_speech_tape)

    os.makedirs(CORPUS_DIR, exist_ok=True)
    sp_path = os.path.join(CORPUS_DIR, "speech_tape.npy")
    no_path = os.path.join(CORPUS_DIR, "noise_tape.npy")
    fl_path = os.path.join(CORPUS_DIR, "floor_tape.npy")
    if force or not os.path.exists(sp_path):
        print("building speech tape (%d utterances)..." % n_speech, flush=True)
        tape = build_speech_tape(TRAIN_SPEECH_SEED, n_speech, log_every=100)
        np.save(sp_path, tape)
        print("  %s: %.1f s of speech" % (sp_path, len(tape) / 16000.0))
    if force or not os.path.exists(no_path):
        print("building noise tape (%d clips)..." % n_noise, flush=True)
        tape = build_noise_tape(TRAIN_NOISE_SEED, n_noise, log_every=100)
        np.save(no_path, tape)
        print("  %s: %.1f s of noise" % (no_path, len(tape) / 16000.0))
    if force or not os.path.exists(fl_path):
        print("building floor tape...", flush=True)
        tape = build_floor_tape(TRAIN_FLOOR_SEED, max(50, n_noise // 4))
        np.save(fl_path, tape)
        print("  %s: %.1f s of floor noise" % (fl_path, len(tape) / 16000.0))
    return sp_path, no_path, fl_path


# Held-out battery: (tag, speech_seed, noise_seed, noise_kind, am_frac), one
# pair a noise kind. Seeds are disjoint from the training seeds and from each
# other; all speech is from the Klatt source-filter family (am_frac 0).
DEV_BATTERY = [
    ("",  9100, 9200, "am",        0.0),   # the first pair keeps its names
    ("2", 9300, 9400, "colored",   0.0),
    ("3", 9500, 9600, "band",      0.0),
    ("4", 9700, 9800, "tonal",     0.0),
    ("5", 9900, 10000, "babble",   0.0),
    ("6", 10100, 10200, "impulsive", 0.0),
    ("7", 10300, 10400, "rumble", 0.0),
]


def build_dev_fixtures(force: bool = False):
    """One 5.855 s speech/noise WAV pair a ``DEV_BATTERY`` row (the reference
    fixtures' length, so the harness runs alike); returns the first pair's
    paths."""
    from koala_tpu_torch.io import write_wav
    from koala_tpu_torch.train.corpus import (build_speech_tape, synth_babble,
                                              synth_noise_clip)

    os.makedirs(SAMPLES_DIR, exist_ok=True)
    n = int(DEV_SECONDS * 16000)
    out = []
    for tag, sp_seed, no_seed, kind, am_frac in DEV_BATTERY:
        sp_path = os.path.join(SAMPLES_DIR, "speech_dev%s.wav" % tag)
        no_path = os.path.join(SAMPLES_DIR, "noise_dev%s.wav" % tag)
        if force or not os.path.exists(sp_path):
            speech = build_speech_tape(sp_seed, 2, dur_range=(3.0, 3.2),
                                       am_frac=am_frac)[:n]
            write_wav(sp_path, np.round(speech * 32767).astype(np.int16))
            print("wrote", sp_path)
        if force or not os.path.exists(no_path):
            rng = np.random.default_rng(no_seed)
            if kind == "babble":
                noise = synth_babble(rng, DEV_SECONDS, 6)
            else:
                noise = synth_noise_clip(rng, DEV_SECONDS, kind)
            noise = noise * NOISE_RMS
            fr = noise[:len(noise) // 256 * 256].reshape(-1, 256)
            worst = float(np.sqrt((fr * fr).mean(axis=1)).max())
            if worst > MAX_FRAME_RMS:
                noise = noise * (MAX_FRAME_RMS / worst)
            write_wav(no_path,
                      np.round(np.clip(noise, -1, 1) * 32767).astype(np.int16))
            print("wrote", no_path)
        out.append((sp_path, no_path))
    return out[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--speech-utts", type=int, default=600)
    ap.add_argument("--noise-clips", type=int, default=300)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    build_training_tapes(args.speech_utts, args.noise_clips, args.force)
    build_dev_fixtures(args.force)


if __name__ == "__main__":
    main()
