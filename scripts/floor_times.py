"""Times of the floor-tracker kernel on a CUDA card, three ways.

    python3 scripts/floor_times.py [--package-root DIR] [--reps N]

At lb [376, 64, 32] and [63, 64, 32] (the serving and the training path's
shapes) it prints, in microseconds per call by CUDA events:

  eager   ``floor_scan`` called in a loop on an idle card, as ``chip_smoke.py``
          times every kernel. At a few microseconds of device work this is the
          host's time to allocate two outputs and make one launch.
  queued  the same calls made while the card is busy with a long spin
          kernel, so that they wait in the stream and run back to back: the
          time the card needs per call.
  raw     the C entry alone on preallocated outputs, queued the same way.

and, where the package has one, a launch that does nothing, the same three
ways. ``--package-root`` names the checkout whose ``koala_tpu_torch`` is
timed (default: the one this script lies in), so two checkouts can be timed
in turns within one call and on one card. Every result is checked
bit-identical to the plain version first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import time_ms  # noqa: E402  (the one timing loop, eager and queued)

SHAPES = ((376, 64, 32), (63, 64, 32))


def per_call_us(fn, reps: int, queued: bool) -> float:
    return time_ms(fn, reps, warmup=5, queued=queued) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=HERE)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("floor_times: needs a CUDA card")
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    from koala_tpu_torch.ops.kernels import _build, floor

    dev = torch.device("cuda", 0)
    lib = _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    result = {"package_root": root, "card": card, "reps": args.reps, "shapes": {}}
    for t_len, b, nb in SHAPES:
        lb = torch.randn((t_len, b, nb), generator=gen, device=dev) * 3.0
        f0 = torch.full((b, nb), 30.0, device=dev)
        kf, kfl = floor.floor_scan(f0, lb, 0.012)
        rf, rfl = floor.floor_scan_ref(f0, lb, 0.012)
        torch.cuda.synchronize()
        if not (torch.equal(kf, rf) and torch.equal(kfl, rfl)):
            sys.exit("floor_times: the kernel differs from its plain version")
        floors, final = torch.empty_like(lb), torch.empty_like(f0)
        stream = _build.stream_handle(dev)

        def raw():
            lib.koala_floor_scan(lb.data_ptr(), f0.data_ptr(), floors.data_ptr(),
                                 final.data_ptr(), t_len, b * nb, 0.012, stream)

        def wrapper():
            floor.floor_scan(f0, lb, 0.012)

        result["shapes"]["%dx%dx%d" % (t_len, b, nb)] = {
            "eager_us": per_call_us(wrapper, args.reps, False),
            "queued_us": per_call_us(wrapper, args.reps, True),
            "raw_us": per_call_us(raw, args.reps, True)}
    if hasattr(floor, "empty_launch"):
        stream = _build.stream_handle(dev)
        result["empty_launch"] = {
            "eager_us": per_call_us(lambda: floor.empty_launch(dev), args.reps, False),
            "queued_us": per_call_us(lambda: floor.empty_launch(dev), args.reps, True),
            "raw_us": per_call_us(lambda: lib.koala_empty_launch(stream), args.reps, True)}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
