"""Batched offline enhancement demo on the PyTorch/CUDA package: many WAV
files enhanced as one batch of concurrent streams on one device.

Usage:
  python demo/koala_demo_batch_torch.py --input_dir noisy/ --output_dir clean/ \
      [--batch 256] [--device best|gpu[:i]|cpu]

The same flags and behaviour as ``demo/koala_demo_batch.py``: files are
padded to the longest utterance of their batch, enhanced in one
delay-compensated ``KoalaBatch.enhance`` call per batch (the fused engine
kernels on a card) and trimmed back to their lengths; throughput is reported
in audio-seconds per second. It runs on the CUDA card unless ``--device cpu``
asks for the CPU.
"""

import argparse
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--access_key", default="DEMOKEY0DEMOKEY0")
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--device", default="best")
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)

    import koala_tpu_torch
    from koala_tpu_torch.io import read_wav, write_wav

    paths = sorted(glob.glob(os.path.join(args.input_dir, "*.wav")))
    if not paths:
        print("no WAV files in", args.input_dir)
        sys.exit(1)
    os.makedirs(args.output_dir, exist_ok=True)

    total_audio = 0.0
    start = time.perf_counter()
    pool = None
    for i in range(0, len(paths), args.batch):
        group = paths[i:i + args.batch]
        pcms = [read_wav(p) for p in group]
        longest = max(len(p) for p in pcms)
        batch = np.zeros((len(group), longest), np.int16)
        for j, p in enumerate(pcms):
            batch[j, :len(p)] = p

        if pool is None or pool.batch_size != len(group):
            if pool is not None:
                pool.delete()
            pool = koala_tpu_torch.create_batch(
                args.access_key, batch_size=len(group),
                model_path=args.model_path, device=args.device)
        else:
            pool.reset()

        enhanced = pool.enhance(batch)
        for j, p in enumerate(group):
            out_path = os.path.join(args.output_dir, os.path.basename(p))
            write_wav(out_path, enhanced[j, :len(pcms[j])])
        total_audio += sum(len(p) for p in pcms) / koala_tpu_torch.SAMPLE_RATE
        print("batch %d: %d files" % (i // args.batch, len(group)), flush=True)

    elapsed = time.perf_counter() - start
    device = pool.device
    pool.delete()
    print("Enhanced %.1f s of audio in %.2f s  (%.0fx real-time) on %s"
          % (total_audio, elapsed, total_audio / elapsed, device))


if __name__ == "__main__":
    main()
