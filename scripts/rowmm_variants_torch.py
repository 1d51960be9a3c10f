"""Every variant of the fixed-order product ``rowmm`` on a CUDA card, at the
port's call-site shapes and row counts: bits and times.

    python3 scripts/rowmm_variants_torch.py [--rows 1,21,64] [--sites stft_re] [--out FILE]

For each (K, N) of the port's frame-local products (the nine of a
``process_chunk`` call and the scan branch's [384, 1152]) and each row
count, on seeded random operands:

  bits   every variant (``rowmm.VARIANTS``, launched through
         ``rowmm.launch`` whatever ``rowmm.plan`` would pick) equal, bit for
         bit, to ``rowmm_simple`` (the first design); also on a permuted
         view of A (the decoder's input) and on operands one float past an
         aligned allocation. Any difference fails the run.
  times  each variant, ``rowmm_simple`` and ``torch.matmul`` (cuBLAS, used
         nowhere in the port) queued behind a spin kernel (the card's time,
         ``koala_tpu_torch.profiling.time_ms``), and the variant that
         ``plan`` picks.

It prints a table a shape and row count (the fastest variant beside the
planned one) and writes every number as JSON to ``--out``. The card's
name and power limit stand in both. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

# (name, K, N) of the frame-local products: process_chunk's nine in their
# order, then the scan branch's GRU projection
SITES = (("stft_re", 512, 257), ("stft_im", 512, 257), ("band", 257, 32), ("cep", 257, 161),
         ("encoder", 329, 384), ("decoder", 384, 257), ("gate", 384, 1),
         ("istft_re", 257, 512), ("istft_im", 257, 512), ("scan_wx", 384, 1152))
# one stream's frame, the battery's 21 streams, the main path's 64, a round of
# 8 frames of the battery, one stream's 376 frames, the one-row kernels'
# limit and one past it, 2048, the battery's 365 x 21, the main path's 376 x 64
ROWS = (1, 21, 64, 168, 376, 1024, 1025, 2048, 7665, 24064)
# the narrow and row kernels are not timed above this many rows (the plan
# gives them no more, and there they take long)
ROW_KERNEL_TIMED_MAX = 8192


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(map(str, ROWS)))
    ap.add_argument("--sites", default=",".join(name for name, _, _ in SITES),
                    help="the call sites to run, by name")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out", "rowmm_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rowmm_variants_torch: needs a CUDA card")
    from koala_tpu_torch.ops.kernels import _build, rowmm
    from koala_tpu_torch.profiling import time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    _build.library()
    table = rowmm.variants_on_card()
    if table != [v[1:] for v in rowmm.VARIANTS]:
        sys.exit("rowmm: the card's variants %s are not the plan's %s"
                 % (table, [v[1:] for v in rowmm.VARIANTS]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows = [int(r) for r in args.rows.split(",")]
    result = {"card": card, "reps": args.reps, "rows": rows, "sites": []}
    failures = []

    def queued(fn):
        return time_ms(fn, args.reps, warmup=2, queued=True)

    with torch.inference_mode():
        sites = args.sites.split(",")
        for name, k, n in (site for site in SITES if site[0] in sites):
            b = torch.randn((k, n), generator=gen, device=dev) * 0.1
            for m in rows:
                a = torch.randn((m, k), generator=gen, device=dev)
                want = rowmm.rowmm_simple(a, b)
                # A as the decoder gets it: a [B, T, K] view of a [T, B, K]
                # tensor; and both operands one float past an aligned allocation
                tb = m // 2 if m % 2 == 0 else m
                perm = a.reshape(m // tb, tb, k).transpose(0, 1).contiguous().transpose(0, 1)
                base_a = torch.empty(m * k + 1, device=dev)
                base_b = torch.empty(k * n + 1, device=dev)
                off_a = base_a[1:].view(m, k).copy_(a)
                off_b = base_b[1:].view(k, n).copy_(b)
                planned = rowmm.plan(m, n, k)
                entry = {"site": name, "m": m, "k": k, "n": n, "planned": planned.name,
                         "simple_ms": queued(lambda: rowmm.rowmm_simple(a, b)),
                         "library_ms": queued(lambda: torch.matmul(a, b)),
                         "bound_ms": max(rowmm.bound(m, k, n).values()), "variants": {}}
                for v, (vname, _, _, _) in enumerate(rowmm.VARIANTS):
                    if v == rowmm.COL and n != 1:
                        continue
                    p = rowmm.plan_for(v, m, n)
                    for label, x, y in (("plain", a, b), ("permuted", perm, b),
                                        ("offset", off_a, off_b)):
                        got = rowmm.launch(x, y, p)
                        if not torch.equal(got.reshape(m, n), want):
                            failures.append("%s %s m=%d (%s)" % (name, vname, m, label))
                    if vname.startswith(("row", "narrow")) and m > ROW_KERNEL_TIMED_MAX:
                        continue
                    entry["variants"][vname] = queued(lambda: rowmm.launch(a, b, p))
                torch.cuda.synchronize()
                best = min(entry["variants"], key=entry["variants"].get)
                entry["best"] = best
                result["sites"].append(entry)
                print("%-8s m=%6d [%d, %d]: planned %-13s %.4f ms, best %-13s %.4f ms, "
                      "simple %.4f, cuBLAS %.4f, bound %.4f"
                      % (name, m, k, n, planned.name, entry["variants"].get(planned.name, -1.0),
                         best, entry["variants"][best], entry["simple_ms"],
                         entry["library_ms"], entry["bound_ms"]), flush=True)
    result["failures"] = failures
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    print("card: %s" % card)
    if failures:
        print("FAIL: %d variant runs differ from rowmm_simple: %s" % (len(failures), failures[:20]))
        sys.exit(1)
    print("rowmm variants: every variant bit-identical to rowmm_simple at every site and row "
          "count (plain, permuted and offset operands)")


if __name__ == "__main__":
    main()
