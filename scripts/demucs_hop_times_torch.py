"""One Demucs stream's hop on a CUDA card: the host's time of a
``Koala.process`` call and the card's time it launches.

    python3 scripts/demucs_hop_times_torch.py [--hops 300] [--traced 50] [--out FILE]

At dns64's widths (``benchmark/configs/demucs-dns64.json``, its weights
drawn from the configuration's seed) it streams one mixture through one
``Koala``, a hop (256 samples) a call, and prints the host's milliseconds a
call (median, 10th and 90th percentiles over ``--hops`` calls after
warm-up); then ``--traced`` more calls under ``torch.profiler``: the card's
milliseconds a hop in kernels and in copies, and the kernels launched a
hop. One JSON line, with the card's name and power limit. It uses only the
public entry points, so it times any version of the package that serves
Demucs: run it from the root of the checkout to be timed. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import koala_tpu_torch as kt  # noqa: E402
from koala_tpu_torch.models import params_io  # noqa: E402
from koala_tpu_torch.models.base import Placeholder  # noqa: E402

HOP = 256
WARMUP_HOPS = 20


def card_time(events):
    """(kernel ns, copy ns, kernels) of a profiler's events on the card."""
    kernel = copy = launched = 0
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if e.name().startswith(("Memcpy", "Memset")):
            copy += e.duration_ns()
        else:
            kernel += e.duration_ns()
            launched += 1
    return kernel, copy, launched


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hops", type=int, default=300, help="Koala.process calls timed")
    ap.add_argument("--traced", type=int, default=50, help="calls under the profiler")
    ap.add_argument("--seed", type=int, default=25)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("demucs_hop_times_torch: needs a CUDA card")
    card_name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    with open(os.path.join("benchmark", "configs", "demucs-dns64.json")) as f:
        cfg = json.load(f)["model"]
    rng = np.random.default_rng(args.seed)
    n_hops = WARMUP_HOPS + args.hops + args.traced
    pcm = np.clip(rng.standard_normal(n_hops * HOP) * 3000.0, -32768, 32767).astype(np.int16)
    hops = pcm.reshape(n_hops, HOP)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dns64.pv")
        params_io.save_params(path, Placeholder(), cfg)
        k = kt.create("HOPTIMES00==", model_path=path, device="gpu")
        try:
            for hop in hops[:WARMUP_HOPS]:
                k.process(hop)
            per_hop = []
            for hop in hops[WARMUP_HOPS:WARMUP_HOPS + args.hops]:
                t0 = time.perf_counter()
                k.process(hop)
                per_hop.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for hop in hops[WARMUP_HOPS + args.hops:]:
                    k.process(hop)
                torch.cuda.synchronize()
        finally:
            k.delete()
    kernel_ns, copy_ns, launched = card_time(prof.profiler.kineto_results.events())
    deciles = statistics.quantiles(per_hop, n=10)
    line = {"demucs_hop": {"process_ms_median": statistics.median(per_hop),
                           "process_ms_p10": deciles[0], "process_ms_p90": deciles[-1],
                           "card_kernel_ms": kernel_ns * 1e-6 / args.traced,
                           "card_copy_ms": copy_ns * 1e-6 / args.traced,
                           "kernels": launched / args.traced},
            "hops": args.hops, "traced": args.traced, "cwd": os.getcwd(), "card": card_name}
    print(json.dumps(line))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
