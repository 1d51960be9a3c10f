"""Times of Demucs's fused U-Net kernels at the cell's shapes, beside their
bounds and their plain versions.

    python3 scripts/unet_fused_times_torch.py [--streams 2048] [--hops 8] [--reps N] [--out FILE]

At dns64's widths and a block of ``--hops`` hops of ``--streams`` streams
(``demucs-dns64.wash.b2048``'s: 2048 x 8) it runs, level by level, each
product of ``rowmm``'s fused entry (the strided convolution: its window over
f32 values rounded on load, bias, ReLU, rounded; the encoder's 1x1: GLU into
a slice of a skip buffer; the decoder's 1x1: GLU, rounded) and each overlap
pass (``ops/kernels/overlap.py``) on seeded operands; holds each to its
plain version (``rowmm.fused_ref``: the plain ``rowmm`` and the PyTorch ops
it stands for; ``overlap_add_ref``) bit for bit; and prints the card's
milliseconds a launch (CUDA events over ``--reps`` launches after warm-up),
the bound (``rowmm.bound``, ``overlap.bound``), the share of the bound and
the plain version's milliseconds, with the card's name and power limit, as
one JSON line. ``chip_smoke.py`` runs ``measure`` for its ``kernels``
line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from koala_tpu_torch.models import demucs  # noqa: E402
from koala_tpu_torch.ops.kernels import overlap, rowmm  # noqa: E402
from koala_tpu_torch.profiling import time_ms  # noqa: E402

DNS64 = dict(demucs.DEFAULT_CONFIG)


def _bf16(t):
    return t.bfloat16().float()


def cases(streams: int, hops: int, device, gen):
    """(name, kernel, plain, bound) of each fused product and overlap pass
    of a block, level by level: kernel and plain are calls that return a
    tensor, bound ``rowmm.bound`` or ``overlap.bound``'s dict."""
    lay, ch = demucs.layout(DNS64["depth"], DNS64["delay_hops"]), demucs.channels(DNS64)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=device, generator=gen) * scale

    for k in range(1, DNS64["depth"] + 1):
        n = lay.per_hop[k] * hops
        c_in, c = ch[k - 1], ch[k]
        m = streams * n
        # the strided convolution: frames of a window over f32 values
        base = randn(streams, 4 * n + 4, c_in)
        a = base.as_strided((streams, n, 8 * c_in), (base.stride(0), 4 * c_in, 1))
        w, b = _bf16(randn(8 * c_in, c, scale=(8 * c_in) ** -0.5)), randn(c, scale=0.1)
        out = torch.empty((streams, n, c), device=device)
        yield ("enc%d" % k, lambda a=a, w=w, b=b, out=out: rowmm.launch_fused(
                   a, w, b, out, relu=True, round_a=True, round_out=True),
               lambda a=a, w=w, b=b, out=out: rowmm.fused_ref(
                   a, w, b, torch.empty_like(out), True, False, True, True),
               rowmm.bound(m, 8 * c_in, c))
        del base
        # the 1x1s: GLU into a skip buffer's slice (f32), and rounded
        h = _bf16(randn(streams, n, c))
        w, b = _bf16(randn(c, 2 * c, scale=c ** -0.5)), randn(2 * c, scale=0.1)
        buf = torch.empty((streams, n + 32, c), device=device)
        yield ("enc%d.glu" % k, lambda h=h, w=w, b=b, buf=buf: rowmm.launch_fused(
                   h, w, b, buf[:, 32:], glu=True),
               lambda h=h, w=w, b=b: rowmm.fused_ref(
                   h, w, b, torch.empty((streams, n, c), device=device), False, True, False,
                   False),
               rowmm.bound(m, c, 2 * c))
        out = torch.empty((streams, n, c), device=device)
        yield ("dec%d.glu" % k, lambda h=h, w=w, b=b, out=out: rowmm.launch_fused(
                   h, w, b, out, glu=True, round_out=True),
               lambda h=h, w=w, b=b: rowmm.fused_ref(
                   h, w, b, torch.empty((streams, n, c), device=device), False, True, False,
                   True),
               rowmm.bound(m, c, 2 * c))
        del buf, out
        # the transposed convolution's tail: the next level's skip and rounding but at level 1
        p = randn(streams, n, 2, 4, c_in)
        carry, bias = randn(streams, 4, c_in), randn(c_in, scale=0.1)
        inner = k > 1
        skip = randn(streams, 4 * n + 32, c_in)[:, :4 * n] if inner else None
        yield ("dec%d.t" % k, lambda p=p, carry=carry, bias=bias, skip=skip, inner=inner:
               overlap.overlap_add(p, carry, bias, inner, skip, inner)[0],
               lambda p=p, carry=carry, bias=bias, skip=skip, inner=inner:
               overlap.overlap_add_ref(p, carry, bias, inner, skip, inner)[0],
               overlap.bound(streams, n, c_in, inner))


def measure(device, streams: int = 2048, hops: int = 8, reps: int = 10):
    """One entry a product and overlap pass of a block: bits against the
    plain version, the kernel's and the plain version's milliseconds, the
    bound and its share, and ``kind`` (``fused``: rowmm's fused entry;
    ``overlap``: the overlap pass)."""
    gen = torch.Generator(device=device).manual_seed(25)
    entries = []
    with torch.inference_mode():
        for name, kernel, plain, bound in cases(streams, hops, device, gen):
            equal = torch.equal(kernel(), plain())
            ms = time_ms(kernel, reps, warmup=2)
            plain_ms = time_ms(plain, 2, warmup=1)
            entries.append({"product": name, "kind": "overlap" if name.endswith(".t") else "fused",
                            "ms": ms, "bound_ms": max(bound.values()),
                            "bound_by": max(bound, key=bound.get),
                            "roofline_pct": 100 * max(bound.values()) / ms, "plain_ms": plain_ms,
                            "bits_equal": equal})
            torch.cuda.empty_cache()
    return entries


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--hops", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("unet_fused_times_torch: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    entries = measure(torch.device("cuda", 0), args.streams, args.hops, args.reps)
    for e in entries:
        print("%-10s %8.3f ms  bound %7.3f (%s, %5.1f%%)  plain %8.3f ms  bits %s"
              % (e["product"], e["ms"], e["bound_ms"], e["bound_by"], e["roofline_pct"],
                 e["plain_ms"], "equal" if e["bits_equal"] else "DIFFER"))
    line = json.dumps({"unet_fused": entries, "streams": args.streams, "hops": args.hops,
                       "card": card, "kernel_ms": sum(e["ms"] for e in entries),
                       "plain_ms": sum(e["plain_ms"] for e in entries)})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    failed = [e["product"] for e in entries if not e["bits_equal"]]
    if failed:
        sys.exit("unet_fused_times_torch: %s differ from their plain versions" % failed)


if __name__ == "__main__":
    main()
