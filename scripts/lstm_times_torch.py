"""Times of the LSTM-cell kernel (``csrc/lstm.cu``) at FullSubNet's four widths
and Demucs's one.

    python3 scripts/lstm_times_torch.py [--package-root DIR] [--reps N] [--out FILE]

At each of the models' layer-steps at the benchmark's batch of 2048 streams
(FullSubNet's full band kx 257 and 512 on 2048 rows at H = 512, its
sub-band's kx 32 and 384 on 526,336 rows at H = 384; Demucs's kx 1024 on
2048 rows at H = 1024, depth 2048, in K-panels) it checks the kernel against its
plain version on the first 257 rows, then prints the card's milliseconds a
launch (CUDA events over ``--reps`` launches after warm-up, outputs
preallocated), the bound (``lstm.bound``), TFLOP/s and the share of the
bound, with the card's name and power limit, as one JSON line.
``--package-root`` names the checkout whose ``koala_tpu_torch`` is timed
(default: the one this script lies in), so two checkouts can be timed in
turns within one call and on one card. It uses only the package's public
``stack_weights``, ``lstm_cell``, ``lstm_cell_ref`` and ``bound``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (band, kx, H, rows) of FullSubNet's layer-steps and Demucs's at B = 2048
SHAPES = (("fullband", 257, 512, 2048), ("fullband", 512, 512, 2048),
          ("subband", 32, 384, 2048 * 257), ("subband", 384, 384, 2048 * 257),
          ("demucs", 1024, 1024, 2048))
ATOL = 2e-5     # h' and c' against the plain version (sums in another order)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_times: needs a CUDA card")
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    from koala_tpu_torch.ops.kernels import lstm
    from koala_tpu_torch.profiling import time_ms

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    result = {"package_root": root, "card": card, "reps": args.reps, "widths": []}
    for band, kx, h, rows in SHAPES:
        g = torch.Generator().manual_seed(kx * 1000 + h)
        raw = [((torch.rand(shape, generator=g) * 2 - 1) / h ** 0.5).to(dev)
               for shape in ((4 * h, kx), (4 * h, h), (4 * h,), (4 * h,))]
        w, b = lstm.stack_weights(*raw)
        state = torch.randn(rows, 2, h, device=dev)
        x, h0, c0 = torch.randn(rows, kx, device=dev), state[:, 1], state[:, 0] * 2
        out_h, out_c = torch.empty(rows, h, device=dev), torch.empty(rows, h, device=dev)
        lstm.lstm_cell(x, h0, c0, w, b, out_h, out_c)
        ref_h, ref_c = lstm.lstm_cell_ref(x[:257], h0[:257], c0[:257], w, b)
        err = max(float((out_h[:257] - ref_h).abs().max()), float((out_c[:257] - ref_c).abs().max()))
        if not err < ATOL:
            sys.exit("lstm_times: %s kx %d is %.3g from the plain version" % (band, kx, err))
        ms = time_ms(lambda: lstm.lstm_cell(x, h0, c0, w, b, out_h, out_c), args.reps, warmup=3)
        bound = lstm.bound(rows, kx, h)
        flops = 2 * rows * (kx + h) * 4 * h
        entry = {"band": band, "kx": kx, "H": h, "rows": rows, "ms": ms,
                 "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get),
                 "tflops": flops / ms / 1e9, "roofline_pct": 100 * max(bound.values()) / ms,
                 "max_abs_err": err}
        result["widths"].append(entry)
        print("lstm_times %s kx %d H %d rows %d: %.4f ms, bound %.4f (%s), %.1f TFLOP/s"
              % (band, kx, h, rows, ms, entry["bound_ms"], entry["bound_by"], entry["tflops"]),
              flush=True)
        del x, h0, c0, state, out_h, out_c
    # FullSubNet's frame: its four layer-steps
    result["frame_ms"] = sum(e["ms"] for e in result["widths"] if e["band"] != "demucs")
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
