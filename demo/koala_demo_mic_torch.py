"""Live microphone enhancement demo on the PyTorch/CUDA package.

Usage:
  python demo/koala_demo_mic_torch.py [--output_path out.wav]
      [--reference_output_path raw.wav] [--input_path in.wav] [--seconds S]
      [--device best|gpu[:i]|cpu] [--show_inference_devices]

The same flags and behaviour as ``demo/koala_demo_mic.py``: a loop of
256-sample frames through ``Koala.process`` with a VU meter, then
``delay_sample`` samples of zero frames that flush the delayed tail, and the
enhanced stream (and, if asked, the raw input) written as WAV. Frames come
from ``--input_path``, read in real time, or else from the microphone
through the optional ``sounddevice`` package. It runs on the CUDA card
unless ``--device cpu`` asks for the CPU.
"""

import argparse
import importlib.util
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def vu_meter(frame: np.ndarray, width: int = 30) -> str:
    rms = np.sqrt(np.mean((frame.astype(np.float64) / 32768.0) ** 2))
    bars = int(min(1.0, rms * 8.0) * width)
    return "[" + "#" * bars + " " * (width - bars) + "]"


def frames_from_wav(path, frame_length, realtime=True):
    from koala_tpu_torch.io import read_wav

    pcm = read_wav(path)
    for start in range(0, len(pcm) - frame_length + 1, frame_length):
        t0 = time.perf_counter()
        yield pcm[start:start + frame_length]
        if realtime:
            left = frame_length / 16000.0 - (time.perf_counter() - t0)
            if left > 0:
                time.sleep(left)


def frames_from_mic(frame_length):
    import sounddevice as sd  # optional dependency

    with sd.InputStream(samplerate=16000, channels=1, dtype="int16",
                        blocksize=frame_length) as stream:
        while True:
            data, _ = stream.read(frame_length)
            yield data.reshape(-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--access_key", default="DEMOKEY0DEMOKEY0")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--device", default="best")
    ap.add_argument("--output_path", default=None,
                    help="write the enhanced stream to this WAV")
    ap.add_argument("--reference_output_path", default=None,
                    help="also record the raw input for A/B comparison")
    ap.add_argument("--input_path", default=None,
                    help="stream this WAV in real time instead of a mic")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--show_inference_devices", action="store_true")
    args = ap.parse_args(argv)

    import koala_tpu_torch
    from koala_tpu_torch.io import write_wav

    if args.show_inference_devices:
        for d in koala_tpu_torch.available_devices():
            print(d)
        return
    if not args.input_path and importlib.util.find_spec("sounddevice") is None:
        print("no microphone backend available (the sounddevice package); use --input_path")
        sys.exit(1)

    koala = koala_tpu_torch.create(access_key=args.access_key,
                                   model_path=args.model_path, device=args.device)
    frame_length = koala.frame_length
    if args.input_path:
        source = frames_from_wav(args.input_path, frame_length)
    else:
        source = frames_from_mic(frame_length)

    enhanced_chunks = []
    raw_chunks = []
    deadline = time.perf_counter() + args.seconds if args.seconds else None
    print("streaming... Ctrl-C to stop")
    try:
        for frame in source:
            out = np.asarray(koala.process(np.asarray(frame).tolist()), np.int16)
            enhanced_chunks.append(out)
            raw_chunks.append(np.asarray(frame, np.int16))
            print("\r" + vu_meter(out), end="", flush=True)
            if deadline and time.perf_counter() > deadline:
                break
    except KeyboardInterrupt:
        pass
    finally:
        print()
        # end of stream: zero frames for delay_sample samples flush the tail
        zeros = [0] * frame_length
        drained = 0
        while drained < koala.delay_sample:
            enhanced_chunks.append(np.asarray(koala.process(zeros), np.int16))
            drained += frame_length

        if args.output_path and enhanced_chunks:
            write_wav(args.output_path, np.concatenate(enhanced_chunks)[koala.delay_sample:])
            print("wrote", args.output_path)
        if args.reference_output_path and raw_chunks:
            write_wav(args.reference_output_path, np.concatenate(raw_chunks))
            print("wrote", args.reference_output_path)
        koala.delete()


if __name__ == "__main__":
    main()
