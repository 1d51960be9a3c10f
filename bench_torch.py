"""Benchmark of the PyTorch/CUDA port: batched enhancement throughput on one card.

    python3 bench_torch.py [--device best|gpu[:i]|cpu]

Prints ONE JSON line with every key of ``bench.py``'s record, measured on the
port (``koala_tpu_torch``) instead of the JAX package:

- the engine number: ``Engine.sequence_fast`` (the fused engine kernels on a
  card) over ``KOALA_BENCH_BATCH`` streams x ``KOALA_BENCH_FRAMES`` hops, the
  input made on the device, one discarded warm-up call, then
  ``KOALA_BENCH_ITERS`` timed calls that carry the state, the window closed by
  a device synchronisation; ``segments`` is the workspace segments of each
  fused call (0 where the fused entry is not taken, as on the CPU);
- ``serving_*``: int16 frames through ``koala_tpu_torch.serve.StreamingServer``
  from a producer thread, the server's capacity over ``KOALA_BENCH_SERVE_SECS``,
  then push-to-pull latency at 25, 50 and 100% pool occupancy;
- ``wire_*``: the host <-> device link (PCIe on a card) for the serving
  payload, and the two throughput ceilings it sets;
- ``step_*``: one stream's ``Engine.step``: host round trip (p50, p99), the
  device's time per step from a chain of steps with no Python between them
  (on a card one step captured as a CUDA graph and replayed), and the time
  per frame of 64-hop ``sequence`` calls.

``KOALA_BENCH_SERVE=0`` skips the serving and wire phases,
``KOALA_BENCH_LATENCY=0`` the step phase. ``device`` is the card's name and
``power_limit_w`` its power limit (null on the CPU). A phase that fails
stops the script with a nonzero exit: no record is printed. Without a card
it stops too, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time

import numpy as np
import torch

from koala_tpu_torch.constants import FRAME_LENGTH, SAMPLE_RATE
from koala_tpu_torch.device import device_scope, resolve_device
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.engine.stream import load_model
from koala_tpu_torch.models import mask_gru
from koala_tpu_torch.models.params_io import default_model_path
from koala_tpu_torch.ops.kernels import engine_fused
from koala_tpu_torch.serve import StreamingServer, _assign, capture_graph

ACCESS_KEY = "benchbench=="
BASELINE_AUDIO_S_PER_S = 32.0     # bench.py's baseline: the reference's best single stream
STEP_BUDGET_MS = 16.0             # one frame's worth of audio
CHAIN_SHORT, CHAIN_LONG = 50, 1050
SEQUENCE_HOPS, SEQUENCE_CALLS = 64, 20
# A client's wait after an empty pull. One that polls without waiting holds
# the interpreter lock against the server's dispatch thread, whose eager
# rounds take it back once for every launch.
POLL_S = 0.0002


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit_w(device: torch.device):
    """The card's power limit in watts, as ``nvidia-smi`` reports it; None
    on the CPU."""
    if device.type != "cuda":
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                        "-i", str(device.index or 0)],
                       capture_output=True, text=True, timeout=60, check=True)
    return float(r.stdout.split()[0])


def load_engine(device: torch.device):
    """(engine, params on ``device``): the bundled model, else a seeded fresh
    ``TRAIN_CONFIG`` model."""
    path = default_model_path()
    if os.path.exists(path):
        return load_model(path, device)
    params = mask_gru.init_params(torch.Generator().manual_seed(0), mask_gru.TRAIN_CONFIG)
    return make_engine("mask_gru", mask_gru.TRAIN_CONFIG), params.to(device)


def planned_segments(engine, batch: int, frames: int) -> int:
    """Workspace segments of one fused call over ``frames`` hops (its
    largest multiple of 8)."""
    lay = engine_fused.Layout(engine.config)
    t8 = frames // engine_fused.T_BLOCK * engine_fused.T_BLOCK
    return -(-t8 // engine_fused.segment_hops(batch, engine_fused.frame_bytes(lay.hidden,
                                                                             lay.nbp)))


@torch.inference_mode()
def engine_bench(engine, params, device: torch.device, batch: int, frames: int,
                 iters: int) -> dict:
    """bench.py's engine record: ``sequence_fast`` on input made on the
    device, state carried across the timed calls."""
    gen = torch.Generator(device=device).manual_seed(0)
    hops = 0.1 * torch.randn((batch, frames, FRAME_LENGTH), generator=gen, device=device)
    state = engine.init_state((batch,), device)

    before = engine_fused.device_launches
    state, out = engine.sequence_fast(params, state, hops)          # warm-up, discarded
    sync(device)
    made = engine_fused.device_launches - before
    segments = made // len(engine_fused.STAGES)
    if device.type == "cuda" and made != len(engine_fused.STAGES) * planned_segments(
            engine, batch, frames):
        raise RuntimeError("sequence_fast did not take the fused entry: %d device launches, "
                           "%d segments planned" % (made, planned_segments(engine, batch, frames)))

    start = time.perf_counter()
    for _ in range(iters):
        state, out = engine.sequence_fast(params, state, hops)
    sync(device)
    elapsed = time.perf_counter() - start
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("sequence_fast gave non-finite output")
    value = batch * frames * FRAME_LENGTH / SAMPLE_RATE * iters / elapsed
    return {"metric": "audio_seconds_per_second_per_chip", "value": value,
            "unit": "audio-s/s/chip", "vs_baseline": value / BASELINE_AUDIO_S_PER_S,
            "batch": batch, "chunk_frames": frames, "iters": iters, "wall_s": elapsed,
            "model": engine.kind, "segments": segments}


def _drain_all(server, expect_frames, deadline_s):
    """Pull everything buffered; stop at ``expect_frames`` or the deadline.
    With ``expect_frames=None``, drain until the pool stays empty for about
    100 ms (output of a round in flight can surface after the last pull)."""
    got = 0
    empty_streak = 0
    deadline = time.perf_counter() + deadline_s
    while time.perf_counter() < deadline:
        _, cnts = server.pull_block(max_frames=64)
        n = int(cnts.sum())
        got += n
        if expect_frames is not None and got >= expect_frames:
            break
        if n == 0:
            empty_streak += 1
            if expect_frames is None and empty_streak >= 20:
                break
            time.sleep(0.005)
        else:
            empty_streak = 0
    return got


def serving_bench(device: torch.device, streams: int, secs: float, chunk: int) -> dict:
    """bench.py's serving record over the port's StreamingServer: a producer
    thread keeps every input ring topped up with batched pushes while this
    thread drains with batched pulls; then push-to-pull latency at 25, 50 and
    100% pool occupancy (the worst stream of each round). A frame that does
    not come back within 2 s fails the phase."""
    cap = max(4 * chunk, 256)
    where = "gpu:%d" % (device.index or 0) if device.type == "cuda" else "cpu"
    server = StreamingServer(ACCESS_KEY, num_streams=streams, device=where,
                             capacity_frames=cap, out_capacity_frames=4 * cap,
                             chunk_frames=chunk, poll_interval_s=0.0005)
    stop = threading.Event()
    prod_thread = None
    try:
        rng = np.random.default_rng(0)
        rows = (rng.standard_normal((streams, chunk, FRAME_LENGTH)) * 1500).astype(np.int16)
        full = np.full((streams,), chunk, np.int32)
        one_frame = rows[:, :1, :].copy()

        # warm-up: a single-frame round and a full-chunk round
        server.push_block(one_frame, np.ones((streams,), np.int32))
        _drain_all(server, streams, deadline_s=60.0)
        server.push_block(rows, full)
        _drain_all(server, streams * chunk, deadline_s=60.0)

        produced = np.zeros((1,), np.int64)

        def producer():
            while not stop.is_set():
                n = server.push_block(rows, full)
                produced[0] += n
                if n < streams * chunk // 2:
                    time.sleep(0.0002)      # rings near full: back off

        prod_thread = threading.Thread(target=producer, daemon=True)
        steps0 = server.stats["device_steps"]
        pulled = 0
        prod_thread.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < secs:
            _, cnts = server.pull_block(max_frames=chunk)
            n = int(cnts.sum())
            pulled += n
            if n == 0:
                time.sleep(POLL_S)
        elapsed = time.perf_counter() - t0
        stop.set()
        prod_thread.join(timeout=5.0)
        steps = server.stats["device_steps"] - steps0
        audio_s = pulled * FRAME_LENGTH / SAMPLE_RATE
        produced_audio_s = float(produced[0]) * FRAME_LENGTH / SAMPLE_RATE
        _drain_all(server, None, deadline_s=3.0)

        occ = {}
        for share, tag in ((0.25, "25"), (0.5, "50"), (1.0, "100")):
            k = max(1, int(streams * share))
            counts = np.zeros((streams,), np.int32)
            counts[:k] = 1
            _drain_all(server, None, deadline_s=5.0)
            lat_ms = []
            for _ in range(40):
                t1 = time.perf_counter()
                server.push_block(one_frame, counts)
                need = k
                while need > 0 and time.perf_counter() - t1 < 2.0:
                    _, cnts = server.pull_block(max_frames=1)
                    n = int(cnts.sum())
                    need -= n
                    if n == 0:
                        time.sleep(POLL_S)
                if need > 0:
                    raise RuntimeError("serving latency: %d of %d frames did not come back "
                                       "within 2 s" % (need, k))
                lat_ms.append((time.perf_counter() - t1) * 1000.0)
            occ["serving_p50_ms_occ" + tag] = float(np.percentile(lat_ms, 50))
            occ["serving_p99_ms_occ" + tag] = float(np.percentile(lat_ms, 99))
    finally:
        stop.set()
        if prod_thread is not None:
            prod_thread.join(timeout=5.0)
        server.close()             # raises if a device round failed while serving
    out = {
        "serving_streams": streams,
        "serving_chunk_frames": chunk,
        "serving_audio_s_per_s_per_chip": audio_s / elapsed,
        "serving_vs_baseline": audio_s / elapsed / BASELINE_AUDIO_S_PER_S,
        "serving_producer_audio_s_per_s": produced_audio_s / elapsed,
        "serving_rounds_per_s": steps / elapsed,
        "serving_frames_per_round": pulled / max(steps, 1),
        "serving_p50_ms": occ["serving_p50_ms_occ100"],
        "serving_p99_ms": occ["serving_p99_ms_occ100"],
    }
    out.update(occ)
    return out


def transport_calibration(device: torch.device, streams: int, chunk: int) -> dict:
    """The host <-> device link for one serving round's int16 payload: upload
    from pageable numpy, download of a fresh device tensor, and the round
    trip of 8 elements, each closed by a device synchronisation; and the
    ceilings they set on serving throughput, serial (up + down + round trip
    a round) and full duplex (the slowest of the three)."""
    payload = np.random.default_rng(1).integers(
        -2000, 2000, (streams, chunk, FRAME_LENGTH), np.int16)
    n_bytes = payload.nbytes                 # one direction
    iters = 6

    def upload():
        x = torch.from_numpy(payload).to(device, copy=True)
        sync(device)
        return x

    y = upload()
    y.to("cpu", copy=True)                   # warm-up both ways
    t0 = time.perf_counter()
    for _ in range(iters):
        upload()
    up_s = (time.perf_counter() - t0) / iters

    t0 = time.perf_counter()
    for _ in range(iters):
        y = y + 1                            # a fresh device tensor each time
        y.to("cpu", copy=True)
    down_s = (time.perf_counter() - t0) / iters

    one = torch.zeros((8,), dtype=torch.int16, device=device)
    (one + 1).to("cpu", copy=True)
    t0 = time.perf_counter()
    for _ in range(20):
        (one + 1).to("cpu", copy=True)
    rtt_s = (time.perf_counter() - t0) / 20

    audio_s_per_round = streams * chunk * FRAME_LENGTH / SAMPLE_RATE
    return {
        "wire_up_mbps": n_bytes / up_s / 1e6,
        "wire_down_mbps": n_bytes / down_s / 1e6,
        "wire_rtt_ms": rtt_s * 1e3,
        "wire_ceiling_serial_audio_s": audio_s_per_round / (up_s + down_s + rtt_s),
        "wire_ceiling_duplex_audio_s": audio_s_per_round / max(up_s, down_s, rtt_s),
    }


class StepChain:
    """One stream's steps chained on the device: each step's enhanced frame
    is the next step's input, and the state is updated in place, so the
    steps are strictly serial and no Python runs between them on a card,
    where one step is captured as a CUDA graph and ``run`` replays it. On
    the CPU ``run`` makes the same steps eagerly. ``state`` and ``hop`` are
    the live buffers."""

    def __init__(self, engine, params, state, hop: torch.Tensor):
        self.engine, self.params = engine, params
        self.state, self.hop = state, hop
        self.graph = None
        if hop.device.type != "cuda":
            return
        # the warm-up is a step whose result is dropped: the state stays as it is
        self.graph = capture_graph(self._step, hop.device,
                                   warm_up=lambda: engine.step(params, state, hop))

    def _step(self) -> None:
        new_state, out = self.engine.step(self.params, self.state, self.hop)
        _assign(self.state, new_state)
        self.hop.copy_(out)

    def run(self, n: int) -> None:
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()


def _chain_seconds(engine, params, device, hop0: torch.Tensor, n: int) -> float:
    """Seconds of ``n`` chained steps from a fresh state: CUDA events around
    replays queued behind a spin kernel on a card (the card's time, not the
    host's), the host clock on the CPU."""
    chain = StepChain(engine, params, engine.init_state((), device), hop0.clone())
    if device.type != "cuda":
        t0 = time.perf_counter()
        chain.run(n)
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync(device)
    torch.cuda._sleep(40_000_000)          # about 20 ms: the replays wait in the stream
    start.record()
    chain.run(n)
    end.record()
    sync(device)
    if not bool(torch.isfinite(chain.hop).all()):
        raise RuntimeError("the step chain gave non-finite output")
    return start.elapsed_time(end) / 1e3


@torch.inference_mode()
def single_stream_latency(engine, params, device: torch.device) -> dict:
    """bench.py's step record for one stream (B = 1): ``Engine.step`` round
    trip from host numpy to host numpy (p50, p99); the device's time per
    step, as the difference quotient of chains of 50 and 1050 steps; the
    time per frame of 64-hop ``sequence`` calls."""
    rng = np.random.default_rng(3)
    hop = (rng.standard_normal((FRAME_LENGTH,)) * 0.05).astype(np.float32)

    state = engine.init_state((), device)
    state, out = engine.step(params, state, torch.as_tensor(hop, device=device))
    out.cpu().numpy()
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        state, out = engine.step(params, state, torch.as_tensor(hop, device=device))
        out.cpu().numpy()
        lat.append((time.perf_counter() - t0) * 1000.0)

    hop_dev = torch.as_tensor(hop, device=device)
    t_short = min(_chain_seconds(engine, params, device, hop_dev, CHAIN_SHORT) for _ in range(3))
    t_long = min(_chain_seconds(engine, params, device, hop_dev, CHAIN_LONG) for _ in range(3))
    device_step_ms = max(t_long - t_short, 0.0) / (CHAIN_LONG - CHAIN_SHORT) * 1000.0

    hops = torch.as_tensor((rng.standard_normal((SEQUENCE_HOPS, FRAME_LENGTH)) * 0.05
                            ).astype(np.float32), device=device)
    state = engine.init_state((), device)
    state, out = engine.sequence(params, state, hops)             # warm-up
    sync(device)
    t0 = time.perf_counter()
    for _ in range(SEQUENCE_CALLS):
        state, out = engine.sequence(params, state, hops)
    sync(device)
    per_frame_ms = (time.perf_counter() - t0) / (SEQUENCE_CALLS * SEQUENCE_HOPS) * 1000.0
    return {
        "step_p50_ms": float(np.percentile(lat, 50)),
        "step_p99_ms": float(np.percentile(lat, 99)),
        "step_device_p50_ms": device_step_ms,
        "step_device_amortized_ms": per_frame_ms,
        "step_budget_ms": STEP_BUDGET_MS,
    }


def run(device: torch.device, batch: int, frames: int, iters: int, serve: bool = True,
        latency: bool = True, serve_streams: int = 128, serve_secs: float = 6.0,
        serve_chunk: int = 64) -> dict:
    """The whole record on ``device``; any phase that fails raises."""
    engine, params = load_engine(device)
    record = engine_bench(engine, params, device, batch, frames, iters)
    record["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    record["power_limit_w"] = power_limit_w(device)
    if serve:
        record.update(serving_bench(device, serve_streams, serve_secs, serve_chunk))
        wire = transport_calibration(device, serve_streams, serve_chunk)
        record.update(wire)
        cap = record["serving_audio_s_per_s_per_chip"]
        record["serving_frac_of_wire_serial"] = cap / wire["wire_ceiling_serial_audio_s"]
        record["serving_frac_of_wire_duplex"] = cap / wire["wire_ceiling_duplex_audio_s"]
    if latency:
        record.update(single_stream_latency(engine, params, device))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="best",
                    help="best | gpu[:i] | cpu (default: best, the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    env = os.environ.get
    with device_scope(device):
        record = run(device, batch=int(env("KOALA_BENCH_BATCH", "512")),
                     frames=int(env("KOALA_BENCH_FRAMES", "376")),
                     iters=int(env("KOALA_BENCH_ITERS", "30")),
                     serve=env("KOALA_BENCH_SERVE", "1") != "0",
                     latency=env("KOALA_BENCH_LATENCY", "1") != "0",
                     serve_streams=int(env("KOALA_BENCH_SERVE_STREAMS", "128")),
                     serve_secs=float(env("KOALA_BENCH_SERVE_SECS", "6.0")),
                     serve_chunk=int(env("KOALA_BENCH_SERVE_CHUNK", "64")))
    print(json.dumps(record))


if __name__ == "__main__":
    main()
