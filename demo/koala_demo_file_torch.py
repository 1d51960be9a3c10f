"""File-enhancement demo on the PyTorch/CUDA package: delay-compensated
streaming over a WAV file.

Usage:
  python demo/koala_demo_file_torch.py --input_path noisy.wav \
      --output_path enhanced.wav [--model_path M] [--device best|gpu[:i]|cpu]
      [--batched] [--show_inference_devices]

The same flags and behaviour as ``demo/koala_demo_file.py``: the frame loop
runs past the end of the input by ``delay_sample`` samples and trims as many
from the head, so the output aligns 1:1 with the input; ``--batched`` makes
one ``enhance`` call instead. It reports the real-time factor. It runs on the
CUDA card unless ``--device cpu`` asks for the CPU.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--access_key", required=False, default="DEMOKEY0DEMOKEY0")
    ap.add_argument("--input_path", required=True)
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--device", default="best")
    ap.add_argument("--library_path", default=None, help="accepted for parity; unused")
    ap.add_argument("--show_inference_devices", action="store_true")
    ap.add_argument("--batched", action="store_true",
                    help="use the single-call batched path instead of the "
                         "frame-by-frame streaming loop")
    args = ap.parse_args(argv)

    import koala_tpu_torch
    from koala_tpu_torch.io import read_wav, write_wav

    if args.show_inference_devices:
        for d in koala_tpu_torch.available_devices():
            print(d)
        return

    koala = koala_tpu_torch.create(
        access_key=args.access_key,
        model_path=args.model_path,
        device=args.device)

    pcm = read_wav(args.input_path)
    length = len(pcm)
    frame_length = koala.frame_length
    delay_sample = koala.delay_sample

    start_time = time.perf_counter()
    if args.batched:
        enhanced = koala.enhance(pcm)
    else:
        # the frame loop runs past the end by delay_sample, with a head trim
        out_chunks = []
        start_sample = 0
        while start_sample < length + delay_sample:
            end_sample = start_sample + frame_length
            frame = np.zeros(frame_length, np.int16)
            src = pcm[start_sample:min(end_sample, length)]
            frame[:len(src)] = src
            out = np.asarray(koala.process(frame.tolist()), np.int16)
            if end_sample > delay_sample:
                if end_sample > length + delay_sample:
                    out = out[:length + delay_sample - start_sample]
                if start_sample < delay_sample:
                    out = out[delay_sample - start_sample:]
                out_chunks.append(out)
            start_sample = end_sample
        enhanced = np.concatenate(out_chunks)
    proc_time = time.perf_counter() - start_time

    write_wav(args.output_path, enhanced)
    audio_time = length / koala.sample_rate
    print("Processed %.3f s of audio in %.3f s on %s" % (audio_time, proc_time, koala.device))
    print("Real time factor: %.3f" % (proc_time / audio_time))
    koala.delete()


if __name__ == "__main__":
    main()
