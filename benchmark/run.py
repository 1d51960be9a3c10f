#!/usr/bin/env python3
"""Run one cell of the benchmark of `koala_tpu_torch` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`. It needs the CUDA
card the cell asks for and exits nonzero, printing no result, without one.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` also `breakdown`, and last `compared`: each number of the
comparison with its limit (also the last lines of standard error).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CACHES = (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda"))


def main(argv=None) -> int:
    root = os.getcwd()
    # the program's and the libraries' build and kernel caches: fixed places
    # in the checkout, so that only a cell's first run there builds
    for var, sub in CACHES:
        os.environ[var] = os.path.join(root, ".bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, root)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not os.path.exists(os.path.join(root, "BENCHMARK.json")):
        print("benchmark: run it from the root of a checkout that holds BENCHMARK.json",
              file=sys.stderr)
        return 2
    from benchmark.harness import run_cell
    return run_cell(root, args.workload, args.seed, args.seconds, args.trace, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
