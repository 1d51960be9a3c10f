"""Long-form streaming demo on the PyTorch/CUDA package: hours of audio in
bounded-memory chunks, the recurrent state carried across chunk boundaries,
and a snapshot of the state that a later run resumes from.

Usage:
  python demo/koala_demo_longform_torch.py --input_path in.wav --output_path out.wav \
      [--chunk_seconds 60] [--loop_hours 2.0] [--state_path state.npz]
      [--device best|gpu[:i]|cpu]

The same flags and behaviour as ``demo/koala_demo_longform.py``. A snapshot
has the JAX package's layout, so either package's demo resumes from either's
snapshot. It runs on the CUDA card unless ``--device cpu`` asks for the CPU.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--access_key", default="DEMOKEY0DEMOKEY0")
    ap.add_argument("--input_path", required=True)
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--device", default="best")
    ap.add_argument("--chunk_seconds", type=float, default=60.0)
    ap.add_argument("--loop_hours", type=float, default=0.0,
                    help="loop the input WAV to simulate this many hours")
    ap.add_argument("--state_path", default=None,
                    help="snapshot streaming state here every chunk; if the "
                         "file exists, resume from it")
    args = ap.parse_args(argv)

    import koala_tpu_torch
    from koala_tpu_torch.io import read_wav, write_wav

    koala = koala_tpu_torch.create(args.access_key, model_path=args.model_path,
                                   device=args.device)
    frame = koala.frame_length
    chunk_samples = max(int(args.chunk_seconds * koala.sample_rate) // frame, 1) * frame

    base = read_wav(args.input_path)
    if args.loop_hours > 0:
        total_samples = int(args.loop_hours * 3600 * koala.sample_rate)
    else:
        total_samples = len(base)

    if args.state_path and os.path.exists(args.state_path):
        koala.load_state(dict(np.load(args.state_path)))
        print("resumed state from", args.state_path)

    out_chunks = []
    done = 0
    start_time = time.perf_counter()
    while done < total_samples:
        n = min(chunk_samples, total_samples - done)
        n = (n // frame) * frame or frame
        # the chunk from the (possibly looped) source
        idx = np.arange(done, done + n) % len(base)
        chunk = base[idx]

        # stream the chunk through the engine; the state carries over
        enhanced = np.concatenate([
            np.asarray(koala.process(chunk[s:s + frame].tolist()), np.int16)
            for s in range(0, n, frame)])
        out_chunks.append(enhanced)
        done += n

        if args.state_path:
            np.savez(args.state_path + ".tmp", **koala.save_state())
            os.replace(args.state_path + ".tmp.npz", args.state_path)

        elapsed = time.perf_counter() - start_time
        audio_s = done / koala.sample_rate
        print("\r%.1f / %.1f audio-min  (RTF %.4f)" % (
            audio_s / 60, total_samples / koala.sample_rate / 60,
            elapsed / audio_s), end="", flush=True)

    print()
    # delay-compensate the concatenated stream: drop the leading delay
    stream = np.concatenate(out_chunks)[koala.delay_sample:]
    write_wav(args.output_path, stream)
    print("wrote", args.output_path)
    koala.delete()


if __name__ == "__main__":
    main()
