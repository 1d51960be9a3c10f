"""Smoke run of koala_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels from koala_tpu_torch/csrc with nvcc (sm_90a) and
   prints the build time, the card's name and its power limit.
2. Drives the port's main path on the bundled model through the public entry
   points, each path with the kernels' launch counters set to 0 just before
   it and read just after: ``Koala.process`` (per-frame, no kernel),
   ``KoalaBatch.process_chunk`` (floor + GRU kernels) and
   ``KoalaBatch.enhance`` (fused engine kernel), at B = 64 streams of 6.0 s
   (T = 376 hops). Checks the delay contract, reset reproducing a fresh
   stream bit for bit, and ``process_chunk`` on the card against the port on
   the CPU for two streams (>= 35 dB).
3. Holds each kernel against its plain PyTorch version on the card, on the
   inputs the main path gave it: floor bit-identical, GRU within its stated
   tolerance, fused >= 40 dB and chunked equal to continuous bit for bit.
   Times kernel, plain version and (where one exists) a library call with
   CUDA events after warm-up, and computes each kernel's bound from its
   shapes and the card's published peaks.
4. Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
   and, last, ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero. Without a CUDA card, or without the
repository beside it, it exits nonzero before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

B, T = 64, 376                 # streams, hops per stream (6.0 s of audio)
PROCESS_FRAMES = 300           # per-frame Koala.process calls
ACCESS_KEY = "SMOKETEST0=="
GRU_SNR_DB = 40.0              # GRU y against its plain version
GRU_MAX_ABS = 0.1              # ... and h_final / y max |err| (bf16 flips, 376 steps)
FUSED_SNR_DB = 40.0
CHUNK_SNR_DB = 35.0


def fail(msg: str) -> None:
    print("FAIL: " + msg, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        fail("nvidia-smi failed: " + r.stderr.strip())
    return r.stdout.strip().splitlines()[0]


def snr_db(ref, x) -> float:
    ref = torch.as_tensor(ref).double().cpu()
    err = torch.as_tensor(x).double().cpu() - ref
    return float(10 * torch.log10((ref ** 2).sum() / (err ** 2).sum().clamp_min(1e-30)))


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone(v) for v in x)
    return x


class Recorder:
    """Wraps ``module.name`` for one main-path run and keeps a copy of the
    arguments of its first call (the inputs the main path gives the kernel)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = None

    def __enter__(self):
        def wrapped(*args):
            if self.args is None:
                self.args = clone(args)
            return self.orig(*args)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def mix_streams(n: int) -> np.ndarray:
    """B streams of n samples: the repository's synth speech + noise mix,
    each stream a different offset and gain (seeded)."""
    from koala_tpu_torch.io import read_wav

    here = os.path.dirname(os.path.abspath(__file__))
    audio = os.path.join(here, "resources", "audio_samples")
    speech = read_wav(os.path.join(audio, "speech_synth.wav")).astype(np.float64)
    noise = read_wav(os.path.join(audio, "noise_synth.wav")).astype(np.float64)
    m = min(len(speech), len(noise))
    mix = np.tile(speech[:m] + noise[:m], -(-(n + m) // m) + 1)
    rng = np.random.default_rng(20261016)
    rows = []
    for _ in range(B):
        off = int(rng.integers(0, m))
        gain = float(rng.uniform(0.5, 1.0))
        rows.append(mix[off:off + n] * gain)
    return np.clip(np.round(np.stack(rows)), -32768, 32767).astype(np.int16)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA card: this script measures the port on a card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import koala_tpu_torch as kt
    except ImportError as e:
        fail("koala_tpu_torch is not beside this script: %s" % e)
    # the kernels must be built from this checkout's sources, not an installed copy
    if os.path.dirname(os.path.dirname(os.path.abspath(kt.__file__))) != here:
        fail("koala_tpu_torch was imported from %s, not from %s" % (kt.__file__, here))
    from koala_tpu_torch.engine import core as engine_core
    from koala_tpu_torch.engine.core import make_engine
    from koala_tpu_torch.models import identity as identity_model
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.ops.kernels import _build, engine_fused, floor, gru

    # True float32 for every float32 product (plain versions, STFT): no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    print("build: %.2f s (%s)" % (time.perf_counter() - t0, os.path.basename(lib_path)))
    print("card: %s" % card, flush=True)

    counters = {"floor_scan": floor, "gru_stack": gru, "engine_fused": engine_fused}

    def reset_counts():
        for m in counters.values():
            m.launches = 0

    def counts():
        return {k: m.launches for k, m in counters.items()}

    # ---- 2. main path through the public surface
    n_chunk = T * 256
    n_enh = (T - 1) * 256          # enhance pads one hop: T hops in total
    pcm = mix_streams(max(n_chunk, n_enh))
    k = kt.create(ACCESS_KEY, device="gpu")
    kb = kt.create_batch(ACCESS_KEY, batch_size=B, device="gpu")
    if k.device.type != "cuda" or kb.device.type != "cuda":
        fail("entry points did not resolve to the card")

    # Koala.process, per frame
    frames = pcm[0, :PROCESS_FRAMES * 256].reshape(PROCESS_FRAMES, 256)
    k.process(frames[0].tolist())            # warm-up (lazy set-up)
    k.reset()
    reset_counts()
    lat, out_proc = [], []
    for f in frames:
        s = time.perf_counter()
        out_proc.append(k.process(f.tolist()))
        lat.append(time.perf_counter() - s)
    proc_counts = counts()
    out_proc = np.asarray(out_proc, np.int16)
    if out_proc.shape != (PROCESS_FRAMES, 256):
        fail("process output shape %s" % (out_proc.shape,))
    print("path Koala.process: %d frames, launches %s" % (PROCESS_FRAMES, proc_counts))

    # reset reproduces a fresh stream bit for bit
    k.reset()
    again = np.asarray([k.process(f.tolist()) for f in frames[:40]], np.int16)
    if not np.array_equal(again, out_proc[:40]):
        fail("Koala.reset did not reproduce a fresh stream")
    fresh = kt.create(ACCESS_KEY, device="gpu")
    if not np.array_equal(np.asarray([fresh.process(f.tolist()) for f in frames[:40]]),
                          out_proc[:40]):
        fail("a new Koala differs from the first one")
    fresh.delete()

    # KoalaBatch.process_chunk: floor + GRU kernels
    kb.process_chunk(pcm[:, :8 * 256])       # warm-up (lazy set-up)
    kb.reset()
    torch.cuda.synchronize()
    reset_counts()
    with Recorder(mask_gru_model, "floor_scan") as rec_floor, \
            Recorder(mask_gru_model, "gru_stack") as rec_gru:
        s = time.perf_counter()
        out_chunk = kb.process_chunk(pcm[:, :n_chunk])
        chunk_s = time.perf_counter() - s
    chunk_counts = counts()
    print("path KoalaBatch.process_chunk: B=%d T=%d, launches %s, %.3f s"
          % (B, T, chunk_counts, chunk_s))
    if chunk_counts["floor_scan"] < 1 or chunk_counts["gru_stack"] < 1:
        fail("process_chunk did not launch the floor and GRU kernels")
    if out_chunk.shape != (B, n_chunk):
        fail("process_chunk output shape %s" % (out_chunk.shape,))

    # the same two streams through the port on the CPU
    cpu = kt.create_batch(ACCESS_KEY, batch_size=2, device="cpu")
    out_cpu = cpu.process_chunk(pcm[:2, :n_chunk])
    cpu.delete()
    chunk_snr = [snr_db(out_cpu[i].astype(np.float64), out_chunk[i].astype(np.float64))
                 for i in range(2)]
    print("process_chunk card vs CPU: %s dB" % ["%.2f" % v for v in chunk_snr])
    if min(chunk_snr) < CHUNK_SNR_DB:
        fail("process_chunk on the card is %.1f dB from the CPU" % min(chunk_snr))

    # KoalaBatch.enhance: fused engine kernel
    kb.reset()
    kb.enhance(pcm[:, :8 * 256])             # warm-up (lazy set-up)
    kb.reset()
    torch.cuda.synchronize()
    reset_counts()
    with Recorder(engine_core, "fused_sequence") as rec_fused:
        s = time.perf_counter()
        out_enh = kb.enhance(pcm[:, :n_enh])
        enh_s = time.perf_counter() - s
    enh_counts = counts()
    print("path KoalaBatch.enhance: B=%d N=%d, launches %s, %.3f s"
          % (B, n_enh, enh_counts, enh_s))
    if enh_counts["engine_fused"] < 1:
        fail("enhance did not launch the fused engine kernel")
    if out_enh.shape != (B, n_enh):
        fail("enhance output shape %s" % (out_enh.shape,))
    for name, out in (("process", out_proc), ("process_chunk", out_chunk),
                      ("enhance", out_enh)):
        if np.all(out == 0):
            fail("%s produced silence" % name)

    # delay contract: the identity engine is a pure 256-sample delay on the card
    ident = make_engine("identity", identity_model.DEFAULT_CONFIG)
    x = torch.as_tensor(pcm[0, :20 * 256].astype(np.float32) / 32768.0, device=dev)
    _, y = ident.sequence(identity_model.Identity().to(dev), ident.init_state((), dev),
                          x.reshape(20, 256))
    y = y.reshape(-1)
    if not (torch.allclose(y[256:], x[:-256], atol=1e-4) and y[:256].abs().max() < 1e-4):
        fail("the identity engine is not a 256-sample delay")
    print("delay contract: ok (%d samples)" % kb.delay_sample)

    launches = {"floor_scan": chunk_counts["floor_scan"],
                "gru_stack": chunk_counts["gru_stack"],
                "engine_fused": enh_counts["engine_fused"]}

    # ---- 3. kernels against their plain versions, on the main path's inputs
    kernels = []

    # floor
    f0, lb, rise = rec_floor.args
    kf, kfl = floor.floor_scan(f0, lb, rise)
    rf, rfl = floor.floor_scan_ref(f0, lb, rise)
    torch.cuda.synchronize()
    if not (torch.equal(kf, rf) and torch.equal(kfl, rfl)):
        fail("floor kernel differs from its plain version")
    t_len, b, nb = lb.shape
    fl_bytes = (2 * t_len * b * nb + 2 * b * nb) * 4
    fl_ops = 2 * t_len * b * nb
    fl_bound = {"bytes": fl_bytes / HBM_BYTES_PER_S * 1e3, "operations": fl_ops / F32_FLOPS * 1e3}
    kernels.append({
        "name": "floor_scan", "route": "cuda", "source": "koala_tpu_torch/csrc/floor.cu",
        "replaces": "koala_tpu/ops/pallas/floor.py:43", "launches": launches["floor_scan"],
        "max_abs_err": max(float((kf - rf).abs().max()), float((kfl - rfl).abs().max())),
        "ms": time_ms(lambda: floor.floor_scan(f0, lb, rise), 50),
        "plain_ms": time_ms(lambda: floor.floor_scan_ref(f0, lb, rise), 3, 1),
        "bound_ms": max(fl_bound.values()), "bound_by": max(fl_bound, key=fl_bound.get),
        "library_ms": None, "shape": [t_len, b, nb]})

    # GRU
    h0, xg, wx, bx, wh, bh = rec_gru.args
    ky, kh = gru.gru_stack(h0, xg, wx, bx, wh, bh)
    ry, rh = gru.gru_stack_ref(h0, xg, wx, bx, wh, bh)
    torch.cuda.synchronize()
    gy_err = float((ky.float() - ry.float()).abs().max())
    gh_err = float((kh - rh).abs().max())
    gy_snr = snr_db(ry.float(), ky.float())
    print("gru: y max|err| %.4g (%.1f dB), h_final max|err| %.4g" % (gy_err, gy_snr, gh_err))
    if gy_snr < GRU_SNR_DB or max(gy_err, gh_err) > GRU_MAX_ABS:
        fail("GRU kernel outside its tolerance against its plain version")
    t_len, b, h = xg.shape
    L = h0.shape[0]
    g_bytes = (2 * t_len * b * h * 2 + 2 * L * b * h * 4
               + 2 * L * h * 3 * h * 2 + 2 * L * 3 * h * 4)
    g_mm = t_len * L * 2 * (2 * b * h * 3 * h)           # bf16 tensor-core flops
    g_ew = t_len * L * b * h * 16 + t_len * L * b * 3 * h * 2   # f32 gate math, bias adds
    # tensor cores and CUDA cores run side by side: the slower of the two bounds
    g_bound = {"bytes": g_bytes / HBM_BYTES_PER_S * 1e3,
               "operations": max(g_mm / BF16_TENSOR_FLOPS, g_ew / F32_FLOPS) * 1e3}
    # yardstick: two cuDNN GRU layers in bf16 with residual adds (gate order
    # r, z, n there; the same work, not the same function of these weights)
    lib_gru = [torch.nn.GRU(h, h).to(dev, torch.bfloat16) for _ in range(L)]
    for m in lib_gru:
        m.flatten_parameters()

    def library_gru():
        xx = xg
        for layer_i, m in enumerate(lib_gru):
            yy, _ = m(xx, h0[layer_i:layer_i + 1].bfloat16())
            xx = xx + yy
        return xx

    with torch.inference_mode():
        lib_ms = time_ms(library_gru, 10)
    kernels.append({
        "name": "gru_stack", "route": "cuda", "source": "koala_tpu_torch/csrc/gru.cu",
        "replaces": "koala_tpu/ops/pallas/gru.py:103", "launches": launches["gru_stack"],
        "max_abs_err": max(gy_err, gh_err),
        "ms": time_ms(lambda: gru.gru_stack(h0, xg, wx, bx, wh, bh), 5, 1),
        "plain_ms": time_ms(lambda: gru.gru_stack_ref(h0, xg, wx, bx, wh, bh), 2, 1),
        "bound_ms": max(g_bound.values()), "bound_by": max(g_bound, key=g_bound.get),
        "library_ms": lib_ms, "shape": [t_len, b, h, L]})

    # fused engine
    params, state, hops, cfg = rec_fused.args
    ks, ko = engine_fused.fused_sequence(params, state, hops, cfg)
    rs, ro = engine_fused.fused_sequence_ref(params, state, hops, cfg)
    t1 = (hops.shape[1] // 2) // 8 * 8
    sa, oa = engine_fused.fused_sequence(params, state, hops[:, :t1], cfg)
    sb, ob = engine_fused.fused_sequence(params, sa, hops[:, t1:], cfg)
    torch.cuda.synchronize()
    fz_snr = snr_db(ro, ko)
    fz_err = float((ko - ro).abs().max())
    print("fused: out %.1f dB against the plain version, max|err| %.4g" % (fz_snr, fz_err))
    if fz_snr < FUSED_SNR_DB:
        fail("fused engine kernel is %.1f dB from its plain version" % fz_snr)
    if not torch.equal(torch.cat([oa, ob], dim=1), ko):
        fail("fused engine kernel: chunked output differs from continuous")
    if not (torch.equal(sb["ola"], ks["ola"]) and torch.equal(sb["model"]["h"], ks["model"]["h"])
            and torch.equal(sb["model"]["floor"], ks["model"]["floor"])):
        fail("fused engine kernel: chunked state differs from continuous")
    print("fused: chunked [0:%d]+[%d:%d] equals continuous bit for bit" % (t1, t1, hops.shape[1]))
    ops = engine_fused.prepare(params, cfg)
    lay = ops["layout"]
    b, t_len, _ = hops.shape
    h, L = lay.hidden, lay.layers
    w_bytes = sum(ops[n].numel() * ops[n].element_size() for n in (
        "fwd", "inv", "band", "cepb", "wenc", "benc", "wcep", "wdec", "bdec",
        "wx", "bx", "wh", "bh"))
    s_bytes = b * (256 * 4 + 2 * 256 * 4 + 2 * lay.nb * 4 + 2 * L * h * 4)
    f_bytes = 2 * b * t_len * 256 * 4 + s_bytes + w_bytes
    # the function's real widths, not the kernel's padded ones: 257 bins
    # (514 re|im DFT columns), nb bands, 161 cepstral lags, the encoder's
    # bins + 2 nb + cep inputs, 257 mask columns + the gate
    bins = cfg["bins"]
    enc_in = bins + 2 * lay.nb + lay.cep
    per_row_mm = 2 * (512 * 2 * bins + bins * lay.nb + (bins * 161 if lay.cep else 0) + enc_in * h
                      + L * 2 * h * 3 * h + h * (bins + 1) + 2 * bins * 512)
    per_row_ew = bins * 12 + lay.nb * 12 + lay.cep * (161 + h * 2) + h * 12 \
        + L * h * 20 + bins * 10 + 256 * 2
    f_bound = {"bytes": f_bytes / HBM_BYTES_PER_S * 1e3,
               "operations": max(b * t_len * per_row_mm / BF16_TENSOR_FLOPS,
                                 b * t_len * per_row_ew / F32_FLOPS) * 1e3}
    kernels.append({
        "name": "engine_fused", "route": "cuda",
        "source": "koala_tpu_torch/csrc/engine_fused.cu",
        "replaces": "koala_tpu/ops/pallas/engine_fused.py:384",
        "launches": launches["engine_fused"], "max_abs_err": fz_err,
        "ms": time_ms(lambda: engine_fused.fused_sequence(params, state, hops, cfg), 5, 1),
        "plain_ms": time_ms(lambda: engine_fused.fused_sequence_ref(params, state, hops, cfg),
                            2, 1),
        "bound_ms": max(f_bound.values()), "bound_by": max(f_bound, key=f_bound.get),
        "library_ms": None, "shape": [b, t_len, 256]})

    # ---- 4. end-to-end numbers of this run
    kb.reset()
    torch.cuda.synchronize()
    s = time.perf_counter()
    kb.enhance(pcm[:, :n_enh])
    enh2_s = time.perf_counter() - s
    audio_s = B * n_enh / 16000.0
    print("enhance: %.1f audio-s/s (B=%d, %.2f s of audio each, %.4f s wall) on %s"
          % (audio_s / enh2_s, B, n_enh / 16000.0, enh2_s, card))
    print("process_chunk: %.1f audio-s/s (B=%d, T=%d, %.4f s wall, first call) on %s"
          % (B * n_chunk / 16000.0 / chunk_s, B, T, chunk_s, card))
    lat_ms = np.asarray(lat) * 1e3
    print("process: per-frame p50 %.3f ms, p90 %.3f ms over %d frames on %s"
          % (np.percentile(lat_ms, 50), np.percentile(lat_ms, 90), len(lat_ms), card))
    for kr in kernels:
        print("kernel %-12s ms %.4f plain_ms %.4f library_ms %s bound_ms %.4f (%s) launches %d"
              % (kr["name"], kr["ms"], kr["plain_ms"],
                 "%.4f" % kr["library_ms"] if kr["library_ms"] is not None else "null",
                 kr["bound_ms"], kr["bound_by"], kr["launches"]))
    k.delete()
    kb.delete()

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
