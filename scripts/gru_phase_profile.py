"""Where a tick of the GRU-stack kernel spends its cycles, on a CUDA card.

    python3 scripts/gru_phase_profile.py [--steps 376 --batch 64 --hidden 384 --layers 2]

Builds ``koala_tpu_torch/csrc/gru.cu`` alone with ``-DKOALA_GRU_PROFILE``
(thread 0 of block 0 then adds up the cycles of each phase of a tick),
launches it on seeded random inputs at the given shape, checks the result
against the plain version, and prints the card's name and power limit and
one JSON object with the cycles per tick of each phase, the kernel's time and
the time of its chain of grid barriers alone. The profiled build is a
measuring tool: the package never loads it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from koala_tpu_torch.ops.kernels import _build, gru  # noqa: E402

PHASES = ("wait_copies", "products", "gates_publish", "arrive_input", "barrier_wait",
          "start_exchange")


def build_profiled() -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(_build.BUILD_DIR, "libkoala_gru_profile.so")
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-DKOALA_GRU_PROFILE", "-I", _build.CSRC, "-shared", "-o", lib,
           os.path.join(_build.CSRC, "gru.cu")]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + done.stdout)
    cdll = ctypes.CDLL(lib)
    args, res = _build._SIGNATURES["koala_gru_stack"]
    cdll.koala_gru_stack.argtypes, cdll.koala_gru_stack.restype = args, res
    return cdll


def time_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=376)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: the profile is of the kernel on a card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(a.seed)
    t_len, b, h, layers = a.steps, a.batch, a.hidden, a.layers

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    h0, x = randn(layers, b, h) * 0.2, (randn(t_len, b, h) * 0.3).bfloat16()
    wx, wh = (randn(layers, h, 3 * h) * 0.05).bfloat16(), (randn(layers, h, 3 * h) * 0.05).bfloat16()
    bx, bh = randn(layers, 3 * h) * 0.1, randn(layers, 3 * h) * 0.1

    lib = build_profiled()
    plan = gru.plan_launch(b, h, layers,
                           sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    y, h_final = torch.empty_like(x), torch.empty_like(h0)
    exchange = torch.empty(plan.exchange_elems, dtype=torch.bfloat16, device=dev)
    counters = torch.zeros(plan.groups + len(PHASES), dtype=torch.int32, device=dev)

    def launch():
        counters.zero_()
        status = lib.koala_gru_stack(
            x.data_ptr(), h0.data_ptr(), wx.data_ptr(), bx.data_ptr(), wh.data_ptr(),
            bh.data_ptr(), y.data_ptr(), None, h_final.data_ptr(), exchange.data_ptr(),
            counters.data_ptr(), t_len, b, h, layers, plan.slice_width, plan.block_layers,
            plan.chunk_rows, plan.chunks, plan.groups, _build.stream_handle(dev))
        _build.check(status, "koala_gru_stack (profiled build)")

    launch()
    torch.cuda.synchronize()
    ref_y, ref_h = gru.gru_stack_ref(h0, x, wx, bx, wh, bh)
    err = max(float((y.float() - ref_y.float()).abs().max()), float((h_final - ref_h).abs().max()))
    if err > 0.1:
        sys.exit("the profiled kernel is %.3g from the plain version" % err)
    ticks = plan.passes * (t_len + layers - 1)
    sums = counters[plan.groups:].cpu().tolist()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    print(json.dumps({
        "shape": {"T": t_len, "B": b, "H": h, "L": layers}, "plan": plan.__dict__,
        "cycles_per_tick": {n: v * 16 / ticks for n, v in zip(PHASES, sums)},
        "ticks": ticks, "max_abs_err": err,
        "profiled_build_ms": time_ms(launch),
        "kernel_ms": time_ms(lambda: gru.gru_stack(h0, x, wx, bx, wh, bh)),
        "barriers_only_ms": time_ms(lambda: gru.grid_barriers(plan, plan.barriers(t_len), dev)),
        "sm_clock_mhz": subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True).stdout.strip()}))


if __name__ == "__main__":
    main()
