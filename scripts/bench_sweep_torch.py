"""Engine sweep of the PyTorch/CUDA port on one card: component split,
roofline, launch census and (batch, chunk) sweep.

    python3 scripts/bench_sweep_torch.py [--device best|gpu[:i]|cpu] [--out PATH]
        [--batch B] [--frames T] [--iters N] [--sweep-batches 256,512]
        [--sweep-frames 188,376,752]

The port's counterpart of ``scripts/bench_sweep.py``, on the bundled model
(384 x 2, 32 bands, 8 cepstral features, bf16; a seeded ``TRAIN_CONFIG``
model where the file is missing), input made on the device:

1.  Component split at B x T (default 512 x 376), each after a warm-up:
    ``Engine.sequence`` (unfused: the floor and GRU kernels beside plain-torch
    frame-local work), ``Engine.sequence_fast`` (the fused entry) with its
    five stages' times and its workspace segments, and the GRU kernel alone
    at [T, B, H]. Roofline of the GRU kernel and of the fused entry against
    their bounds (each kernel module's ``bound`` over ``profiling.bound``: an
    H100 SXM's dense peaks, 989 TFLOP/s bf16 and 3.35 TB/s); ``tensor_fraction`` is the bound over
    the measured time.
1b. Components: the no-tracker ablation (``snr_bands=0``, no floor level,
    no cepstral features, the encoder cut to its log-magnitude rows: another
    function of the same structure, which is all a time needs), STFT +
    iSTFT alone on [B, T, 512] frames, the floor kernel alone on
    [T, B, nb] queued behind a spin kernel (the card's time), and the host
    work that ``KoalaBatch.process_chunk`` does around ``sequence`` at this
    shape (int16 -> float in numpy, the upload, the download, float -> int16),
    by the wall clock.
1c. Census of one unfused ``sequence`` call through ``profiling.trace``: the
    device's kernels by name and count, grouped as the port's own, GEMMs,
    elementwise and reductions, copies (with their bytes), and the call's
    wall time beside the sum of its kernels' device time.
2.  Sweep of ``sequence_fast`` over ``b`` x ``t``: audio-s/s, ms a chunk,
    segments, and the best row.

``bench_sweep.py`` also swept the TPU kernel's VMEM batch tile (``b_tile``).
The port's fused entry has no such parameter: it tiles 64 frames and plans
its workspace segments itself, and the sweep's ``segments`` column stands
in its place.

Times on a card are CUDA events; on the CPU (``--device cpu``: the kernels'
plain versions, no fused entry) wall clocks, and every roofline field is
null. Small sizes come from the flags or ``KOALA_SWEEP_BATCH``,
``KOALA_SWEEP_FRAMES``, ``KOALA_SWEEP_ITERS``, ``KOALA_SWEEP_BATCHES``,
``KOALA_SWEEP_CHUNKS``. Writes ``resources/reports/engine_roofline_torch.json``
(``--out`` elsewhere) and prints the record as one JSON line. Without a card
it stops, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from koala_tpu_torch import profiling  # noqa: E402
from koala_tpu_torch.constants import FRAME_LENGTH, SAMPLE_RATE  # noqa: E402
from koala_tpu_torch.device import device_scope, resolve_device  # noqa: E402
from koala_tpu_torch.engine.core import float_to_pcm, make_engine, pcm_to_float  # noqa: E402
from koala_tpu_torch.models import params_io  # noqa: E402
from koala_tpu_torch.ops import stft as stft_ops  # noqa: E402
from koala_tpu_torch.ops.kernels import engine_fused, floor, gru  # noqa: E402

DEFAULT_OUT = os.path.join(REPO, "resources", "reports", "engine_roofline_torch.json")
# the port's own kernels (koala_tpu_torch/csrc), by their names in a trace
PORT_KERNELS = re.compile(r"\b(front_kernel|encode_kernel|back_kernel|gru_stack_kernel|"
                          r"floor_scan_kernel|grid_barriers_kernel|empty_kernel|"
                          r"rowmm_narrow_kernel|rowmm_row_kernel|rowmm_col_kernel|"
                          r"rowmm_tile_kernel|rowmm_simple_kernel|mmse_gain_kernel)\b")
GEMM_KERNELS = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas|Kernel2", re.I)
# bytes of the element types that torch.profiler names in "Input type"
TYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "long int": 8,
              "int": 4, "bool": 1, "signed char": 1, "unsigned char": 1, "short int": 2}


def time_call(fn, device: torch.device, reps: int) -> float:
    """Mean ms of ``fn`` after one warm-up call: CUDA events on a card, the
    wall clock on the CPU."""
    if device.type == "cuda":
        return profiling.time_ms(fn, reps, warmup=1)
    return profiling.wall_ms(fn, reps)


def roofline(bound, ms, device: torch.device):
    """The measured time against its bound; every field null off a card."""
    if device.type != "cuda":
        return {"bound_ms": None, "bound_by": None, "bytes_ms": None, "operations_ms": None,
                "tensor_fraction": None}
    best = max(bound, key=bound.get)
    return {"bound_ms": bound[best], "bound_by": best, "bytes_ms": bound["bytes"],
            "operations_ms": bound["operations"], "tensor_fraction": bound[best] / ms}


def load_engine(device: torch.device):
    """(engine, params on ``device``) of the bundled model, as ``bench_torch.py``."""
    import bench_torch

    return bench_torch.load_engine(device)


def _hops(device: torch.device, batch: int, frames: int, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return 0.1 * torch.randn((batch, frames, FRAME_LENGTH), generator=gen, device=device)


@torch.inference_mode()
def component_split(engine, params, device: torch.device, batch: int, frames: int,
                    iters: int) -> dict:
    """Section 1: ``sequence``, ``sequence_fast`` with its stages, the GRU
    kernel alone, and the roofline of the last two."""
    cfg = engine.config
    hops = _hops(device, batch, frames)
    state = engine.init_state((batch,), device)
    seq_ms = time_call(lambda: engine.sequence(params, state, hops), device, iters)

    before = engine_fused.device_launches
    fast_ms = time_call(lambda: engine.sequence_fast(params, state, hops), device, iters)
    made = engine_fused.device_launches - before
    segments = made // len(engine_fused.STAGES) // (iters + 1)
    stage_ms = None
    if segments:
        # the stages by CUDA events inside the entry: the median of five calls
        t8 = frames // engine_fused.T_BLOCK * engine_fused.T_BLOCK
        runs = []
        for _ in range(5):
            runs.append({})
            engine_fused.fused_sequence(params, state, hops[:, :t8], cfg, stage_ms=runs[-1])
        stage_ms = {n: statistics.median(r[n] for r in runs) for n in engine_fused.STAGES}

    h, layers = cfg["hidden"], cfg["num_layers"]
    gen = torch.Generator(device=device).manual_seed(1)
    x = (0.3 * torch.randn((frames, batch, h), generator=gen, device=device)).bfloat16()
    h0 = torch.zeros((layers, batch, h), device=device)
    wx, bx, wh, bh = params.gru_stacked()
    kernel_ms = time_call(lambda: gru.gru_stack(h0, x, wx, bx, wh, bh), device, iters)
    return {
        "sequence_ms": seq_ms,
        "full_sequence_ms": fast_ms,
        "fused_segments": segments,
        "fused_stage_ms": stage_ms,
        "kernel_ms": kernel_ms,
        "kernel_shape": [frames, batch, h, layers],
        "non_kernel_ms": seq_ms - kernel_ms,
        "kernel_roofline": roofline(gru.bound(frames, batch, h, layers, False),
                                    kernel_ms, device),
        "fused_roofline": roofline(engine_fused.bound(params, cfg, batch, frames),
                                   fast_ms, device),
    }


def no_tracker_engine(engine, params, device: torch.device):
    """The ablated model of ``bench_sweep.py``: no tracker, no floor level,
    no cepstral features, the encoder cut to the log-magnitude rows."""
    tree = params_io.params_to_numpy(params)
    bins = engine.config["bins"]
    tree["enc"] = {"w": tree["enc"]["w"][:bins], "b": tree["enc"]["b"]}
    cfg = dict(engine.config, snr_bands=0, floor_feat=False, cep_feats=0)
    return make_engine("mask_gru", cfg), params_io.params_from_numpy(tree, device, "mask_gru")


def components(engine, params, device: torch.device, batch: int, frames: int,
               iters: int) -> dict:
    """Section 1b: the no-tracker ablation through ``sequence``, STFT +
    iSTFT alone, the floor kernel alone (queued behind a spin kernel on a
    card)."""
    # made outside inference mode: its derived weights are cached by version
    ablated = no_tracker_engine(engine, params, device) if engine.config.get("snr_bands") \
        else None
    with torch.inference_mode():
        return _components(engine, ablated, device, batch, frames, iters)


def _components(engine, ablated, device, batch, frames, iters) -> dict:
    hops = _hops(device, batch, frames)
    comp = {}
    if ablated is not None:
        eng_nf, p_nf = ablated
        st_nf = eng_nf.init_state((batch,), device)
        comp["no_tracker_ms"] = time_call(lambda: eng_nf.sequence(p_nf, st_nf, hops), device,
                                          iters)
    gen = torch.Generator(device=device).manual_seed(2)
    frames_512 = 0.1 * torch.randn((batch, frames, 2 * FRAME_LENGTH), generator=gen,
                                   device=device)
    comp["stft_istft_ms"] = time_call(
        lambda: stft_ops.istft_frame(*stft_ops.stft_frame(frames_512)), device, iters)
    nb = engine.config.get("snr_bands") or 32
    lb = torch.randn((frames, batch, nb), generator=gen, device=device)
    f0 = torch.full((batch, nb), 30.0, device=device)
    rise = float(engine.config.get("floor_rise", 0.012))
    if device.type == "cuda":
        comp["floor_scan_ms"] = profiling.time_ms(lambda: floor.floor_scan(f0, lb, rise), 200,
                                                  5, queued=True)
    else:
        comp["floor_scan_ms"] = time_call(lambda: floor.floor_scan(f0, lb, rise), device, iters)
    comp["floor_shape"] = [frames, batch, nb]
    comp["floor_roofline"] = roofline(floor.bound(frames, batch, nb),
                                      comp["floor_scan_ms"], device)
    comp["host"] = host_split(device, batch, frames, iters)
    return comp


def host_split(device: torch.device, batch: int, frames: int, iters: int) -> dict:
    """Wall ms of each step of ``KoalaBatch.process_chunk``'s host work
    around ``sequence`` on [batch, frames * 256] int16: ``pcm_to_float``,
    the upload, the download of the output, ``float_to_pcm``."""
    rng = np.random.default_rng(3)
    pcm = rng.integers(-3000, 3000, (batch, frames * FRAME_LENGTH), dtype=np.int16)
    x = pcm_to_float(pcm)
    on_device = torch.as_tensor(x, device=device)

    def wall_ms(fn):
        return profiling.wall_ms(fn, iters, device=device)

    return {"pcm_to_float_ms": wall_ms(lambda: pcm_to_float(pcm)),
            "upload_ms": wall_ms(lambda: torch.as_tensor(x, device=device)),
            "download_ms": wall_ms(lambda: on_device.cpu().numpy()),
            "float_to_pcm_ms": wall_ms(lambda: float_to_pcm(x)),
            "samples": int(pcm.size)}


def _copy_bytes(event) -> int:
    """Bytes an ``aten::copy_`` reads and writes, from its recorded shapes."""
    args = event.get("args", {})
    dims, types = args.get("Input Dims") or [], args.get("Input type") or []
    total = 0
    for d, t in list(zip(dims, types))[:2]:
        if isinstance(d, list) and t in TYPE_BYTES:
            n = 1
            for v in d:
                n *= int(v)
            total += n * TYPE_BYTES[t]
    return total


def census_of_trace(path: str) -> dict:
    """The device's kernels and copies in a Chrome trace of
    ``profiling.trace``, grouped, with their device time."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    groups = {g: {"count": 0, "device_ms": 0.0, "kernels": {}}
              for g in ("port", "gemm", "elementwise_reduction", "copy")}
    copy_bytes = {"memcpy": 0, "copy_kernels": 0}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "cpu_op" and name == "aten::copy_":
            copy_bytes["copy_kernels"] += _copy_bytes(e)
            continue
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if cat == "gpu_memcpy":
            group = "copy"
            copy_bytes["memcpy"] += int(e.get("args", {}).get("bytes", 0))
        elif cat == "gpu_memset":
            group = "elementwise_reduction"
        elif PORT_KERNELS.search(name):
            group = "port"
        elif GEMM_KERNELS.search(name):
            group = "gemm"
        elif "copy" in name.lower():
            group = "copy"
        else:
            group = "elementwise_reduction"
        g = groups[group]
        g["count"] += 1
        g["device_ms"] += float(e.get("dur", 0.0)) / 1e3
        short = name[:120]
        g["kernels"][short] = g["kernels"].get(short, 0) + 1
    groups["copy"]["bytes"] = copy_bytes
    return groups


@torch.inference_mode()
def census(engine, params, device: torch.device, batch: int, frames: int) -> dict:
    """Section 1c: one unfused ``sequence`` call (after a warm-up) traced by
    ``profiling.trace``, with shapes recorded for the copies' bytes."""
    hops = _hops(device, batch, frames)
    state = engine.init_state((batch,), device)
    engine.sequence(params, state, hops)                 # warm-up, outside the trace
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp, record_shapes=True):
            wall_ms = profiling.wall_ms(lambda: engine.sequence(params, state, hops), 1,
                                        warmup=0, device=device)
        groups = census_of_trace(os.path.join(tmp, profiling.TRACE_FILE))
    device_ms = sum(g["device_ms"] for g in groups.values())
    launches = sum(g["count"] for g in groups.values())
    on_card = device.type == "cuda"
    return {"call": "Engine.sequence", "shape": [batch, frames, FRAME_LENGTH],
            "wall_ms": wall_ms, "device_ms": device_ms if on_card else None,
            "device_launches": launches, "groups": groups,
            "device_busy_fraction": device_ms / wall_ms if on_card else None}


@torch.inference_mode()
def sweep(engine, params, device: torch.device, batches, frames_list, iters: int):
    """Section 2: ``sequence_fast`` at every (batch, chunk): audio-s/s, ms a
    chunk and the fused entry's workspace segments."""
    rows = []
    for b in batches:
        for t in frames_list:
            hops = _hops(device, b, t)
            holder = {"state": engine.init_state((b,), device)}

            def run(hops=hops, holder=holder):
                holder["state"], _ = engine.sequence_fast(params, holder["state"], hops)

            before = engine_fused.device_launches
            ms = profiling.wall_ms(run, iters, device=device)
            segments = (engine_fused.device_launches - before) // len(engine_fused.STAGES) \
                // (iters + 1)
            rows.append({"batch": b, "chunk_frames": t,
                         "audio_s_per_s": b * t * FRAME_LENGTH / SAMPLE_RATE / ms * 1e3,
                         "ms_per_chunk": ms, "segments": segments})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def card_keys(device: torch.device) -> dict:
    """The card's name and power limit beside every number (null on the CPU)."""
    import bench_torch

    return {"device": str(device),
            "name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "power_limit_w": bench_torch.power_limit_w(device)}


def run(device: torch.device, batch: int, frames: int, iters: int, batches, frames_list,
        sweep_iters: int) -> dict:
    """The whole report on ``device``."""
    engine, params = load_engine(device)
    report = dict(card_keys(device), model=engine.kind, batch=batch, frames=frames,
                  iters=iters)
    report.update(component_split(engine, params, device, batch, frames, iters))
    report["components"] = components(engine, params, device, batch, frames, iters)
    report["census"] = census(engine, params, device, batch, frames)
    report["sweep"] = sweep(engine, params, device, batches, frames_list, sweep_iters)
    report["best"] = max(report["sweep"], key=lambda r: r["audio_s_per_s"])
    return report


def _ints(text: str):
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> dict:
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="best",
                    help="best | gpu[:i] | cpu (default: best, the CUDA card)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--batch", type=int, default=int(env("KOALA_SWEEP_BATCH", "512")))
    ap.add_argument("--frames", type=int, default=int(env("KOALA_SWEEP_FRAMES", "376")))
    ap.add_argument("--iters", type=int, default=int(env("KOALA_SWEEP_ITERS", "20")))
    ap.add_argument("--sweep-batches", default=env("KOALA_SWEEP_BATCHES", "256,512"))
    ap.add_argument("--sweep-frames", default=env("KOALA_SWEEP_CHUNKS", "188,376,752"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with device_scope(device):
        report = run(device, args.batch, args.frames, args.iters, _ints(args.sweep_batches),
                     _ints(args.sweep_frames), max(1, args.iters // 2))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report), flush=True)
    print("best: %s -> wrote %s" % (report["best"], args.out))
    return report


if __name__ == "__main__":
    main()
