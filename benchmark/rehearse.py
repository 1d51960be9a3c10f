#!/usr/bin/env python3
"""Rehearse a cell's comparison on many seeds in one process, with the control.

    python3 benchmark/rehearse.py --workload <cell> --seeds 11,12,13 --seconds 10 \\
        [--control 3] [--layers]

For each seed it runs the cell as `run.py` does (set-up, the window, the
sample of what the window produced) and prints one JSON line: the
end-to-end numbers, the comparison's numbers with each stream's (and its
loudest sample), and for the first `--control` seeds the same numbers of
the control: the reference at the configuration's `control` precision in
the program's place. `--layers` (the `mask_gru` kind) adds, for the
sampled streams of the first seed, how far each layer's output of the
program's unfused path (`Engine.sequence_full`, the card's kernels) lies
from the reference's, and the fused entry's kernels from their plain
version. The limits in `cells/` are set from these readings; the
benchmark's own runs do not run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def rel(a, b):
    """||a - b|| / ||b|| per stream (leading axis), the largest."""
    d = (a.double() - b.double()).flatten(1)
    return float((d.norm(dim=1) / b.double().flatten(1).norm(dim=1).clamp(min=1e-30)).max())


def layers(run, items):
    """Each layer's output of the program's unfused path against the
    reference's, and the fused entry's kernels against their plain version."""
    import numpy as np
    import torch
    from benchmark import compare
    from koala_tpu_torch.engine.core import make_engine
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.ops.kernels import engine_fused

    dev = run.device
    hops = torch.as_tensor(np.stack([it["hops"] for it in items]), device=dev)
    tree, cfg = params_io.load_params(run.model_path)
    eng = make_engine(cfg.get("kind", "mask_gru"), cfg)
    params = params_io.params_from_numpy(tree, dev, "mask_gru")
    keep = {}
    ref = compare.reference(run)
    y = ref.enhance(hops, run.config["precision"], 0, keep)
    out = {}
    with torch.inference_mode():
        _, prog, mask, (re, im) = eng.sequence_full(params, eng.init_state((len(items),), dev),
                                                    hops)
        out["spectrum"] = rel(torch.cat([re, im], -1), keep["spectrum"])
        out["mask"] = rel(mask, keep["mask"])
        out["output"] = rel(prog, y)
        d = (prog - y).abs().amax(dim=(0, 2))
        out["output_worst_hop"] = int(d.argmax())
        dm = (mask - keep["mask"]).abs().amax(dim=(0, 2))
        out["mask_first_hop_over_1e-3"] = int(torch.nonzero(dm > 1e-3)[0]) if (dm > 1e-3).any() \
            else None
        t8 = hops.shape[1] // engine_fused.T_BLOCK * engine_fused.T_BLOCK
        if t8 and engine_fused.fused_sequence_supported(cfg, len(items), t8, dev):
            st = eng.init_state((len(items),), dev)
            _, k_out = engine_fused.fused_sequence(params, st, hops[:, :t8], cfg)
            _, p_out = engine_fused.fused_sequence_ref(params, eng.init_state((len(items),), dev),
                                                       hops[:, :t8], cfg)
            keep_f = {}
            y_f = ref.enhance(hops[:, :t8], run.config["precision"], t8, keep_f)
            out["fused_kernel_vs_plain"] = rel(k_out, p_out)
            out["fused_plain_vs_reference"] = rel(p_out, y_f)
            out["fused_kernel_vs_reference"] = rel(k_out, y_f)
    return out


def main(argv=None) -> int:
    root = os.getcwd()
    sys.path.insert(0, root)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--layers", action="store_true")
    args = p.parse_args(argv)
    import torch
    from benchmark import compare
    from benchmark.harness import HERE, Run, measure
    if not torch.cuda.is_available():
        print("rehearse: needs a CUDA card", file=sys.stderr)
        return 2
    t0 = T_START
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = Run(root, HERE, args.workload, seed, args.seconds, 0, "cuda:0")
        m = measure(run, t0)
        rec = {"seed": seed, "e2e": m["e2e"], "memory_peak_bytes": m["device"]["memory_peak_bytes"],
               "attempted": m["attempted"], "failed": m["failed"]}
        t1 = time.perf_counter()
        prog = compare.compare(run, m["sample"], run.config["precision"])
        rec["compare_s"] = time.perf_counter() - t1
        rec["program"] = prog
        if i < args.control:
            rec["control"] = compare.compare(run, compare.control_items(run, m["sample"]),
                                             run.config["precision"])
        if args.layers and i == 0 and run.config["kind"] == "mask_gru":
            rec["layers"] = layers(run, m["sample"][:8])
        print(json.dumps(rec), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
