"""Train the mask_gru model with the PyTorch/CUDA package and evaluate it.

Usage:
    python scripts/train_model_torch.py --out /tmp/model.pv [--steps 20000]
    python scripts/train_model_torch.py --cpu --steps 200 --batch 8 \
        --segment-frames 31 --speech-utts 20 --noise-clips 20 --out /tmp/model.pv
    python scripts/train_model_torch.py --eval-only [--out model.pv] [--gate]
        [--reference-samples DIR]

Training runs on the CUDA card unless ``--cpu`` is given (without a card it
stops with an error; it never carries on on the CPU by itself). The tapes
are the synthetic multi-speaker corpus of ``koala_tpu_torch.train.corpus``,
built on demand from fixed seeds and cached under ``resources/corpus/``. The
fixture pairs under ``resources/audio_samples/`` are acceptance material,
never part of the tapes: they are evaluated as held-out sets after training,
and so is the reference pair (``test.wav``, ``noise.wav``) when a directory
that holds it is named with ``--reference-samples`` or in the environment as
``KOALA_REFERENCE_SAMPLES``. Training needs ``--out``; only ``--eval-only``
falls back on the bundled model. The model file loads in both packages.

``--speech A.wav ... --noise B.wav ...`` trains on tapes made from WAV files
instead of the corpus, as ``scripts/train_model.py`` does: every speech file
at speeds 0.9, 1.0 and 1.1, and the noise files followed by 30 s each of
white, pink and brown noise.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from make_corpus_torch import DEV_BATTERY  # held-out battery: (tag, seeds, kind, am)

OWN_SAMPLES = os.path.join(REPO, "resources", "audio_samples")
CORPUS_DIR = os.path.join(REPO, "resources", "corpus")

TRAIN_SPEECH_SEED = 100
TRAIN_NOISE_SEED = 200
TRAIN_FLOOR_SEED = 300


def build_wav_tapes(speech_paths, noise_paths):
    """(speech, noise) tapes from WAV files: each speech file at speeds 0.9,
    1.0 and 1.1, the noise files padded with 30 s each of white, pink and
    brown noise at 0.05 (seed 7). Bit-identical to scripts/train_model.py's."""
    from koala_tpu_torch.io import read_wav
    from koala_tpu_torch.train.data import speed_perturb, synth_noise

    rng = np.random.default_rng(7)
    speech = []
    for p in speech_paths:
        s = read_wav(p).astype(np.float32) / 32768.0
        for f in (0.9, 1.0, 1.1):
            speech.append(speed_perturb(s, f) if f != 1.0 else s)
    noise = [read_wav(p).astype(np.float32) / 32768.0 for p in noise_paths]
    for color in ("white", "pink", "brown"):
        noise.append(synth_noise(rng, 30 * 16000, color) * 0.05)
    return np.concatenate(speech), np.concatenate(noise)


def build_corpus_tapes(n_speech: int, n_noise: int):
    """(speech, noise, floor) tapes from the corpus synthesiser, cached as
    .npy files named after their seeds and sizes."""
    from koala_tpu_torch.train.corpus import (build_floor_tape, build_noise_tape,
                                              build_speech_tape)

    os.makedirs(CORPUS_DIR, exist_ok=True)
    n_floor = max(50, n_noise // 4)
    jobs = (("speech", TRAIN_SPEECH_SEED, n_speech, build_speech_tape, {"log_every": 100}),
            ("noise", TRAIN_NOISE_SEED, n_noise, build_noise_tape, {"log_every": 100}),
            ("floor", TRAIN_FLOOR_SEED, n_floor, build_floor_tape, {}))
    tapes = []
    for name, seed, count, build, kwargs in jobs:
        path = os.path.join(CORPUS_DIR, "%s_tape_seed%d_n%d.npy" % (name, seed, count))
        if not os.path.exists(path):
            print("building %s tape (%d clips)..." % (name, count), flush=True)
            np.save(path, build(seed, count, **kwargs))
        tapes.append(np.load(path))
    return tuple(tapes)


def fixture_sets(reference_samples=None):
    """{set name: (speech, noise)} int16 of every fixture set present: the
    reference pair and its pseudo-real variants (when ``reference_samples``
    names a directory that holds it), the synthetic fixture and the held-out
    battery under ``resources/audio_samples/``."""
    from koala_tpu_torch.io import read_wav
    from koala_tpu_torch.train.pseudo_real import variants

    sets = {}
    if reference_samples:
        sets["reference"] = (os.path.join(reference_samples, "test.wav"),
                             os.path.join(reference_samples, "noise.wav"))
    sets["synth_fixture"] = (os.path.join(OWN_SAMPLES, "speech_synth.wav"),
                             os.path.join(OWN_SAMPLES, "noise_synth.wav"))
    for tag, _, _, kind, _ in DEV_BATTERY:
        sets["dev_heldout%s:%s" % (tag, kind)] = (
            os.path.join(OWN_SAMPLES, "speech_dev%s.wav" % tag),
            os.path.join(OWN_SAMPLES, "noise_dev%s.wav" % tag))
    loaded = {}
    for name, (sp, no) in sets.items():
        if not (os.path.exists(sp) and os.path.exists(no)):
            print("[skip %s: fixtures missing]" % name)
            continue
        loaded[name] = (read_wav(sp), read_wav(no))
    # pseudo-real invariance battery over the one real recording, where present
    if "reference" in loaded:
        for case, pair in variants(*loaded["reference"]).items():
            loaded["reference_%s" % case] = pair
    return loaded


def eval_all(params, cfg, reference_samples=None):
    """Evaluate on every fixture set present; returns {set_name: metrics}.
    ``reference_samples``: a directory with the reference pair, or None."""
    from koala_tpu_torch.train.evaluate import evaluate

    all_results = {}
    for name, (sp_pcm, no_pcm) in fixture_sets(reference_samples).items():
        res = evaluate(params, cfg, sp_pcm, no_pcm, device="cpu")
        all_results[name] = res
        ok = (res["dev_pure_speech"] < 0.02 and res["dev_pure_noise"] < 0.02
              and res["dev_mixed"] < 0.02)
        print("== %s: %s" % (name, "PASS" if ok else "FAIL"))
        for k, v in res.items():
            print("   %-22s %.4f" % (k, v))
    return all_results


def check_gates(results, allow_known_gaps: bool = False) -> bool:
    """The acceptance gates: energy parity < 0.02 on every set, no STOI
    regression beyond 0.01, SI-SDR gain > 3 dB (and > 12 dB SI-SDR on the
    reference mix). With ``allow_known_gaps``, gates listed in
    tests/known_gaps.py downgrade to warnings while the measured value stays
    within its regression bound of the recorded one; any other gate stays
    hard. Returns True iff everything passes."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from known_gaps import KNOWN_GAPS, regression_bound
    known = KNOWN_GAPS if allow_known_gaps else {}
    ok = True

    def gate(cond, what, key=None, value=None):
        nonlocal ok
        if cond:
            return
        if key is not None and key in known and value is not None:
            bound = regression_bound(key[1], known[key])
            within = value >= bound if key[1] == "si_sdr_gain" else value <= bound
            if within:
                print("GATE KNOWN-GAP (allowed): %s" % what)
                return
            what += (" [REGRESSED beyond the recorded gap %.4f, bound %.4f]"
                     % (known[key], bound))
        ok = False
        print("GATE FAIL: %s" % what)

    for name, r in results.items():
        for key in ("dev_pure_speech", "dev_pure_noise", "dev_mixed"):
            gate(r[key] < 0.02, "%s %s=%.4f >= 0.02" % (name, key, r[key]),
                 key=(name, "parity"), value=r[key])
        gate(r["stoi_mixed"] > r["stoi_input"] - 0.01,
             "%s stoi regresses %.3f -> %.3f" % (name, r["stoi_input"], r["stoi_mixed"]),
             key=(name, "stoi"), value=r["stoi_input"] - r["stoi_mixed"])
        gate(r["si_sdr_gain_db"] > 3.0,
             "%s si_sdr_gain=%.1f <= 3 dB" % (name, r["si_sdr_gain_db"]),
             key=(name, "si_sdr_gain"), value=r["si_sdr_gain_db"])
    if "reference" in results:
        gate(results["reference"]["si_sdr_mixed_db"] > 12.0,
             "reference si_sdr_mixed=%.1f <= 12 dB" % results["reference"]["si_sdr_mixed_db"])
    print("ALL GATES PASS" if ok else "GATES FAILED")
    return ok


def warm_start(path: str, seed: int, device):
    """(params, cfg) from a model file, upgraded to the current training
    recipe: the tracker settings of TRAIN_CONFIG, and a fresh init for every
    head the file lacks or holds at another shape."""
    import torch

    from koala_tpu_torch.models import mask_gru, params_io

    loaded, loaded_cfg = params_io.load_params(path)
    cfg = dict(loaded_cfg)
    for key in ("snr_bands", "floor_feat", "floor_rise", "snr_scale", "snr_clip"):
        cfg[key] = mask_gru.TRAIN_CONFIG[key]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fresh = params_io.params_to_numpy(mask_gru.init_params(gen, cfg))

    def merge(new, old):
        if isinstance(new, dict):
            return {k: merge(v, old[k]) if k in old else v for k, v in new.items()}
        if isinstance(new, list):
            return [merge(f, l) for f, l in zip(new, old)]
        return new if tuple(np.shape(new)) != tuple(np.shape(old)) else old

    return merge(fresh, loaded), cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segment-frames", type=int, default=125)
    ap.add_argument("--speech-utts", type=int, default=600)
    ap.add_argument("--noise-clips", type=int, default=300)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--init-from", default=None, help="warm-start model file")
    ap.add_argument("--out", default=None,
                    help="model file to write and evaluate; required when training, "
                         "the bundled model with --eval-only")
    ap.add_argument("--reference-samples", default=os.environ.get("KOALA_REFERENCE_SAMPLES"),
                    help="directory with the reference pair test.wav + noise.wav "
                         "(default: $KOALA_REFERENCE_SAMPLES; evaluated only when given)")
    ap.add_argument("--report", default=None, help="write eval JSON here")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 unless every acceptance gate passes")
    ap.add_argument("--allow-known-gaps", action="store_true",
                    help="gates listed in tests/known_gaps.py downgrade to warnings")
    ap.add_argument("--speech", nargs="*", default=None,
                    help="WAV-tape mode: speech WAV files (in place of the corpus)")
    ap.add_argument("--noise", nargs="*", default=None,
                    help="WAV-tape mode: noise WAV files")
    args = ap.parse_args(argv)
    if not args.eval_only and not args.out:
        ap.error("--out is required when training (only --eval-only falls back on "
                 "the bundled model)")

    from koala_tpu_torch.device import resolve_device
    from koala_tpu_torch.models import mask_gru, params_io
    from koala_tpu_torch.train.train import train_on_device

    out_path = args.out or params_io.default_model_path()
    device = "cpu" if args.cpu else "best"

    if not args.eval_only:
        dev = resolve_device(device)        # fails here, before the tapes, without a card
        params, cfg = None, dict(mask_gru.TRAIN_CONFIG)
        if args.init_from:
            params, cfg = warm_start(args.init_from, args.seed, dev)
        if args.speech or args.noise:
            speech_tape, noise_tape = build_wav_tapes(args.speech or [], args.noise or [])
            floor_tape = None
        else:
            speech_tape, noise_tape, floor_tape = build_corpus_tapes(
                args.speech_utts, args.noise_clips)
        print("tapes: speech %.1f s, noise %.1f s"
              % (len(speech_tape) / 16000.0, len(noise_tape) / 16000.0), flush=True)
        params, cfg = train_on_device(
            speech_tape, noise_tape, steps=args.steps, batch=args.batch, lr=args.lr,
            seed=args.seed, segment_frames=args.segment_frames, config=cfg, params=params,
            floor_tape=floor_tape, device=device)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        params_io.save_params(out_path, params, cfg)
        print("saved", out_path, "(%d bytes)" % os.path.getsize(out_path))

    params, cfg = params_io.load_params(out_path)
    results = eval_all(params, cfg, args.reference_samples)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(results, f, indent=1)
        print("report ->", args.report)
    if args.gate and not check_gates(results, args.allow_known_gaps):
        sys.exit(1)


if __name__ == "__main__":
    main()
