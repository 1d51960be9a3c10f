"""Times of the mmse gain kernel (``csrc/mmse.cu``) against its bound.

    python3 scripts/mmse_times_torch.py [--reps N] [--out FILE]

At the corpus wash's [8192, 375, 257] (``mmse.wash.b8192.pinned``: 8192
streams of 6.0 s) and at ``process_chunk``'s [64, 376, 257] it holds the
kernel to its plain version (``mmse_gain_ref``, the loop of ``gain_frame``
on the card) bit for bit, masks and every state leaf, then prints the card's
milliseconds a launch (CUDA events over ``--reps`` launches after warm-up;
at 64 streams queued behind a spin kernel, since the host launches slower
than the card runs it), the bound (``mmse.bound``), the share of the bound
and the plain loop's milliseconds, with the card's name and power limit, as
one JSON line. The spectra are seeded: each (stream, frame) at its own level
between 1e-6 and 1e3, so the SNR clamps at both ends are reached.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from koala_tpu_torch.models import mmse as mmse_model  # noqa: E402
from koala_tpu_torch.ops.kernels import mmse  # noqa: E402
from koala_tpu_torch.profiling import time_ms  # noqa: E402

# (streams, frames, queued): the wash's batch, and process_chunk's, whose
# launch the host makes slower than the card runs it
SHAPES = ((8192, 375, False), (64, 376, True))
BINS = 257


def gain_case(n: int, t_len: int, device, seed: int = 0):
    """(re, im, noise, prev_gain2_post, count) of ``n`` fresh streams over
    ``t_len`` frames on ``device``, seeded."""
    g = torch.Generator(device=device).manual_seed(seed)
    level = torch.exp(torch.empty(n, t_len, 1, device=device).uniform_(
        float(np.log(1e-6)), float(np.log(1e3)), generator=g))
    re, im = (torch.randn(n, t_len, BINS, device=device, generator=g) * level for _ in range(2))
    st = mmse_model.init_state((n,), mmse_model.DEFAULT_CONFIG, device)
    return re, im, st["noise"], st["prev_gain2_post"], st["count"]


def measure(device, reps: int = 20):
    """One entry a shape: bits against the plain version, the kernel's and
    the plain loop's milliseconds, the bound and its share."""
    entries = []
    for n, t_len, queued in SHAPES:
        args = gain_case(n, t_len, device, seed=n + t_len) + mmse_model.gain_rule(None)
        got = mmse.mmse_gain(*args)
        want = mmse.mmse_gain_ref(*args)
        names = ("noise", "prev_gain2_post", "count", "mask")
        differ = [k for k, a, b in zip(names, got, want) if not torch.equal(a, b)]
        del got, want
        ms = time_ms(lambda: mmse.mmse_gain(*args), reps, warmup=3, queued=queued)
        plain_ms = time_ms(lambda: mmse.mmse_gain_ref(*args), 1, warmup=1)
        bound = mmse.bound(t_len, n, BINS)
        entries.append({"streams": n, "frames": t_len, "bins": BINS, "ms": ms,
                        "queued": queued, "bound_ms": max(bound.values()),
                        "bound_by": max(bound, key=bound.get),
                        "roofline_pct": 100 * max(bound.values()) / ms,
                        "gb_per_s": 3350.0 * bound["bytes"] / ms,
                        "plain_ms": plain_ms, "bits_equal": not differ, "differ": differ})
        del args
        torch.cuda.empty_cache()
    return entries


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mmse_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    entries = measure(dev, args.reps)
    for e in entries:
        print("mmse_times [%d, %d, %d]: %.4f ms%s, bound %.4f (%s), %.1f%% of it, plain loop "
              "%.2f ms, bits %s" % (e["streams"], e["frames"], e["bins"], e["ms"],
                                    " queued" if e["queued"] else "", e["bound_ms"],
                                    e["bound_by"], e["roofline_pct"], e["plain_ms"],
                                    "equal" if e["bits_equal"] else "DIFFER in %s" % e["differ"]),
              flush=True)
    line = json.dumps({"card": card, "reps": args.reps, "shapes": entries})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if not all(e["bits_equal"] for e in entries):
        sys.exit("mmse_times: the kernel differs from its plain version")


if __name__ == "__main__":
    main()
