"""Smoke run of koala_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels from koala_tpu_torch/csrc with nvcc (sm_90a) and
   prints the build time, the card's name and its power limit.
2. Drives the port's main path on the bundled model through the public entry
   points, each path with the kernels' launch counters set to 0 just before
   it and read just after: ``Koala.process`` (per-frame, no kernel),
   ``KoalaBatch.process_chunk`` (floor + GRU kernels) and
   ``KoalaBatch.enhance`` (the fused engine's kernels), at B = 64 streams of
   6.0 s (T = 376 hops). Checks the delay contract, reset reproducing a fresh
   stream bit for bit, and ``process_chunk`` and ``enhance`` on the card
   against the port on the CPU for two streams (>= 35 dB).
3. Holds each kernel against its plain PyTorch version on the card, on the
   inputs the main path gave it: floor bit-identical, GRU within its stated
   tolerance, fused >= 40 dB, chunked equal to continuous and launch equal to
   launch bit for bit. The floor kernel is also held bit-identical at a
   column count that is no multiple of 32, at T = 1 and over several slabs;
   the fused kernels against their plain version at B = 1, 17, 128, 300
   (T = 40), at T = 8 and over two workspace segments, each from a state that
   is not zero. The GRU kernel is also held against its plain version at B = 1, 17, 128
   and 300, at H = 64 with one layer and H = 128 with three, and at T = 0;
   two launches must give the same bits, a sequence in two chunks the bits
   of one run, and the plan's shared-memory size must be the kernel's.
   Times kernel, plain version and (where one exists) a library call with
   CUDA events after warm-up, computes each kernel's bound from its shapes
   and the card's published peaks and, for the GRU kernel, times its chain
   of grid barriers alone (the sequential floor of its design, and of the
   fused engine's, whose GRU stage it is). The floor kernel is timed like the
   others (``ms``: a loop on an idle card, which at a few microseconds reads
   the host) and queued behind a spin kernel (``queued_ms``: the card's
   time), beside a launch that does nothing, timed both ways; of the fused
   entry it prints the time of each of its five stages and the device
   launches that ``enhance``'s own call made.
4. Drives the training path through ``train_on_device`` and
   ``make_train_step`` at the full width of ``TRAIN_CONFIG`` (B = 64 x T = 63
   from a seeded ``init_params`` on tapes from the corpus synthesiser), again
   with the counters set to 0 just before and read just after: every step
   launches the GRU kernel's ``return_hidden`` variant and the floor kernel
   once and the fused kernel never. Checks finite losses, a falling loss on
   one fixed batch, the trained weights saved, loaded and used through
   ``create_batch``; holds the ``return_hidden`` variant against the
   inference variant (bit-identical y and h_final) and its plain version at
   B = 64 x 63, 128 x 125 and a ragged B = 40; holds both differentiable
   wrappers against autograd through their plain versions, and the loss and
   its gradients on the card against the port on the CPU; holds the floor
   kernel against its plain version on the training path's inputs too
   (bit-identical); times a train step and its parts at B = 64 x 63 and
   B = 128 x 125, each shape twice.
5. Times ``enhance`` and ``process_chunk`` five more times each (a first
   call carries one-off host work), then prints one
   ``{"kernels": [...]}`` line, the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero. Without a CUDA card, or without the
repository beside it, it exits nonzero before printing a result.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
FUSED_FLOOR_ABS = 2e-2         # a flipped bf16 rounding of a band power moves its log by 2**-8
CHUNK_SNR_DB = 35.0
TRAIN_B, TRAIN_T = 64, 63      # train_on_device's own defaults
RECIPE_B, RECIPE_T = 128, 125  # the training script's recipe
TRAIN_STEPS = 20
GRAD_COS = 0.999               # kernel-forward gradients against autograd through the
GRAD_NORM = 0.02               # plain version: per-leaf cosine and relative norm
LOSS_REL = 1e-3                # loss on the card against the port on the CPU
LOSS_GRAD_COS = 0.99           # ... and its per-leaf gradient cosine


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


def time_ms(fn, reps: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after warm-up).
    ``queued``: the calls are made while the card is busy with a spin kernel
    of about 20 ms, so they wait in the stream and run back to back. That is
    the card's time for a kernel of a few microseconds, which the host cannot
    launch as fast as the card runs it: without it the events time the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)
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
        def wrapped(*args, **kwargs):
            if self.args is None:
                self.args = clone(args)
            return self.orig(*args, **kwargs)
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


def cosine(a, b) -> float:
    a, b = a.double().flatten().cpu(), b.double().flatten().cpu()
    return float(torch.dot(a, b) / (a.norm() * b.norm()).clamp_min(1e-300))


def gru_bound(t_len, b, h, layers, hidden_out: bool):
    """Least time (ms) of the GRU stack on this card, by bytes and by
    operations: x and y bf16, h in and out f32, the weights once, and with
    ``hidden_out`` the streamed states hs [T, L, B, H] f32; bf16 products on
    the tensor cores beside the f32 gate math on the CUDA cores (the two run
    side by side, so the slower of them)."""
    n_bytes = (2 * t_len * b * h * 2 + 2 * layers * b * h * 4
               + 2 * layers * h * 3 * h * 2 + 2 * layers * 3 * h * 4
               + (t_len * layers * b * h * 4 if hidden_out else 0))
    mm = t_len * layers * 2 * (2 * b * h * 3 * h)
    ew = t_len * layers * b * h * 16 + t_len * layers * b * 3 * h * 2
    return {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
            "operations": max(mm / BF16_TENSOR_FLOPS, ew / F32_FLOPS) * 1e3}


def cudnn_gru_yardstick(xg, h0, training: bool):
    """The library yardstick of the GRU stack: one cuDNN ``nn.GRU`` per layer
    in bf16 with residual adds (gate order r, z, n there: the same work, not
    the same function of the port's weights). ``training``: the forward
    writes the reserve space of a backward pass. Timed here, used nowhere in
    the port."""
    h = xg.shape[-1]
    layers = [torch.nn.GRU(h, h).to(xg.device, torch.bfloat16).train(training)
              for _ in range(h0.shape[0])]
    for m in layers:
        m.flatten_parameters()

    def run():
        xx = xg
        for i, m in enumerate(layers):
            yy, _ = m(xx, h0[i:i + 1].bfloat16())
            xx = xx + yy
        return xx

    return run


def gru_launch_keys(gru, x, layers):
    """What the plan of a GRU launch on x [T, B, H] says, and the time of its
    chain of grid barriers alone on the same grid: the floor that the
    dependent ticks of this design cannot go below."""
    plan = gru.plan_for(x, layers)
    n = plan.barriers(x.shape[0])
    return {"sequential_floor_ms": time_ms(lambda: gru.grid_barriers(plan, n, x.device), 10),
            "barriers": n, "grid": [plan.groups, plan.slices], "blocks": plan.blocks,
            "slice_width": plan.slice_width, "chunk_rows": plan.chunk_rows,
            "passes": plan.passes, "smem_bytes": plan.smem_bytes}


def gru_shape_checks(gru, lib, dev, weights):
    """The GRU kernel against its plain version away from the main path's
    shape: ragged, single-row and many-pass batches at the model's width
    (``weights``: its stacked wx, bx, wh, bh), narrow stacks of one and three
    layers on seeded random weights, T = 0; both variants each time. Then
    chunked against continuous and launch against launch, bit for bit."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def random_weights(h, layers):
        return ((randn(layers, h, 3 * h) * (1.5 / h ** 0.5)).bfloat16(), randn(layers, 3 * h) * 0.1,
                (randn(layers, h, 3 * h) * (1.5 / h ** 0.5)).bfloat16(), randn(layers, 3 * h) * 0.1)

    model_h, model_layers = weights[0].shape[1], weights[0].shape[0]
    cases = [(12, 1, model_h, model_layers, weights), (9, 17, model_h, model_layers, weights),
             (8, 128, model_h, model_layers, weights), (6, 300, model_h, model_layers, weights),
             (0, 5, model_h, model_layers, weights),
             (16, 40, 64, 1, random_weights(64, 1)), (16, 64, 128, 3, random_weights(128, 3)),
             (5, 300, 128, 3, random_weights(128, 3))]
    for t_len, b, h, layers, w in cases:
        h0, x = randn(layers, b, h) * 0.2, (randn(t_len, b, h) * 0.3).bfloat16()
        plan = gru.plan_for(x, layers)
        theirs = lib.koala_gru_smem_bytes(h, layers, plan.slice_width, plan.chunk_rows)
        if theirs != plan.smem_bytes or plan.smem_bytes > gru.H100_SMEM_BYTES:
            fail("gru plan: %d bytes of shared memory, the kernel lays out %d"
                 % (plan.smem_bytes, theirs))
        y0, hf0 = gru.gru_stack(h0, x, *w)
        y1, hs1, hf1 = gru.gru_stack(h0, x, *w, return_hidden=True)
        ry, rhs, rhf = gru.gru_stack_ref(h0, x, *w, return_hidden=True)
        torch.cuda.synchronize()
        if not (torch.equal(y0, y1) and torch.equal(hf0, hf1)
                and (t_len == 0 or torch.equal(hs1[-1], hf1))):
            fail("gru T=%d B=%d H=%d L=%d: the two variants differ" % (t_len, b, h, layers))
        if t_len == 0 and not (torch.equal(hf0, h0) and y0.shape == x.shape):
            fail("gru T=0: h_final is not h0")
        errs = [float((a.float() - r.float()).abs().max()) if a.numel() else 0.0
                for a, r in ((y0, ry), (hf0, rhf), (hs1, rhs))]
        db = snr_db(ry.float(), y0.float()) if t_len else float("inf")
        print("gru T=%d B=%d H=%d L=%d (%d x %d blocks, %d rows a chunk, %d pass%s): y max|err| "
              "%.4g (%.1f dB), h_final %.4g, hs %.4g"
              % (t_len, b, h, layers, plan.groups, plan.slices, plan.chunk_rows, plan.passes,
                 "" if plan.passes == 1 else "es", errs[0], db, errs[1], errs[2]))
        if max(errs) > GRU_MAX_ABS or db < GRU_SNR_DB:
            fail("GRU kernel outside its tolerance at T=%d B=%d H=%d L=%d" % (t_len, b, h, layers))
    # one sequence in two chunks, state handed over, and the same launch twice
    h0, x = randn(model_layers, 40, model_h) * 0.2, (randn(29, 40, model_h) * 0.3).bfloat16()
    y, hs, hf = gru.gru_stack(h0, x, *weights, return_hidden=True)
    ya, hsa, ha = gru.gru_stack(h0, x[:11], *weights, return_hidden=True)
    yb, hsb, hb = gru.gru_stack(ha, x[11:], *weights, return_hidden=True)
    y2, hs2, hf2 = gru.gru_stack(h0, x, *weights, return_hidden=True)
    torch.cuda.synchronize()
    if not (torch.equal(torch.cat([ya, yb]), y) and torch.equal(hb, hf)
            and torch.equal(torch.cat([hsa, hsb]), hs)):
        fail("GRU kernel: chunked [0:11]+[11:29] differs from continuous")
    if not (torch.equal(y, y2) and torch.equal(hs, hs2) and torch.equal(hf, hf2)):
        fail("GRU kernel: two launches on the same inputs differ")
    print("gru: chunked [0:11]+[11:29] equals continuous, and launch equals launch, bit for bit")


def floor_shape_checks(floor, dev):
    """The floor kernel bit-identical to its plain version away from the main
    path's shape: a column count that is no multiple of 32 (nor of 4: rows
    not 16-byte aligned), one frame, several slabs with a ragged last one."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    for t_len, b, nb in ((40, 37, 30), (1, 64, 32), (130, 3, 7), (200, 9, 36), (1000, 64, 32)):
        lb = torch.randn((t_len, b, nb), generator=gen, device=dev) * 3.0
        f0 = torch.randn((b, nb), generator=gen, device=dev) * 2.0 + 1.0
        kf, kfl = floor.floor_scan(f0, lb, 0.012)
        rf, rfl = floor.floor_scan_ref(f0, lb, 0.012)
        torch.cuda.synchronize()
        if not (torch.equal(kf, rf) and torch.equal(kfl, rfl)):
            fail("floor kernel differs from its plain version at lb [%d, %d, %d]"
                 % (t_len, b, nb))
    print("floor: bit-identical to its plain version at [40,37,30], [1,64,32], [130,3,7], "
          "[200,9,36], [1000,64,32]")


def fused_states_equal(a, b) -> bool:
    return (torch.equal(a["input_carry"], b["input_carry"]) and torch.equal(a["ola"], b["ola"])
            and torch.equal(a["model"]["h"], b["model"]["h"])
            and torch.equal(a["model"]["floor"], b["model"]["floor"]))


def fused_shape_checks(engine_fused, engine, params, cfg, dev):
    """The fused kernels against their plain version away from the main
    path's shape: single-stream, ragged, wide and many-pass batches at
    T = 40, T = 8, and a T that crosses a workspace segment; each from the
    state that eight hops leave behind (nothing of it zero)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    lay = engine_fused.Layout(cfg)
    per_frame = engine_fused.frame_bytes(lay.hidden, lay.nbp)
    crossing = engine_fused.segment_hops(300, per_frame) + 5
    for b, t_len in ((1, 40), (17, 40), (128, 40), (300, 40), (64, 8), (300, crossing)):
        hops = torch.randn((b, t_len + 8, 256), generator=gen, device=dev) * 0.05
        state, _ = engine_fused.fused_sequence(params, engine.init_state((b,), dev),
                                               hops[:, :8], cfg)
        hops = hops[:, 8:].contiguous()
        segments = -(-t_len // engine_fused.segment_hops(b, per_frame))
        before = engine_fused.device_launches
        ks, ko = engine_fused.fused_sequence(params, state, hops, cfg)
        if engine_fused.device_launches - before != len(engine_fused.STAGES) * segments:
            fail("fused B=%d T=%d: %d device launches for %d segment(s)"
                 % (b, t_len, engine_fused.device_launches - before, segments))
        rs, ro = engine_fused.fused_sequence_ref(params, state, hops, cfg)
        torch.cuda.synchronize()
        db = snr_db(ro, ko)
        errs = {"ola": float((ks["ola"] - rs["ola"]).abs().max()),
                "h": float((ks["model"]["h"] - rs["model"]["h"]).abs().max()),
                "floor": float((ks["model"]["floor"] - rs["model"]["floor"]).abs().max())}
        print("fused B=%d T=%d (%d segment%s): out %.1f dB, max|err| %.3g; state max|err| ola "
              "%.3g, h %.3g, floor %.3g" % (b, t_len, segments, "" if segments == 1 else "s", db,
                                            float((ko - ro).abs().max()), errs["ola"], errs["h"],
                                            errs["floor"]))
        if not torch.isfinite(ko).all() or db < FUSED_SNR_DB:
            fail("fused kernels are %.1f dB from their plain version at B=%d T=%d"
                 % (db, b, t_len))
        if errs["h"] > GRU_MAX_ABS or errs["floor"] > FUSED_FLOOR_ABS or errs["ola"] > 1e-2:
            fail("fused kernels' state outside its tolerance at B=%d T=%d: %s" % (b, t_len, errs))
        if t_len == crossing:
            if segments != 2:
                fail("B=300 T=%d should take two workspace segments, took %d"
                     % (t_len, segments))
            sa, oa = engine_fused.fused_sequence(params, state, hops[:, :40], cfg)
            sb, ob = engine_fused.fused_sequence(params, sa, hops[:, 40:], cfg)
            torch.cuda.synchronize()
            if not (torch.equal(torch.cat([oa, ob], dim=1), ko) and fused_states_equal(sb, ks)):
                fail("fused kernels: two segments differ from two calls cut elsewhere")
            print("fused: %d + %d hops in two segments equal [0:40]+[40:%d] in two calls, bit "
                  "for bit" % (crossing - 5, 5, t_len))


def grad_agreement(name, got, want):
    """(cosine, relative norm difference) of two gradients; fails the run
    outside GRAD_COS / GRAD_NORM."""
    cos = cosine(got, want)
    got, want = got.double().flatten(), want.double().flatten()
    dnorm = abs(float(got.norm() / want.norm().clamp_min(1e-300)) - 1.0)
    if cos < GRAD_COS or dnorm > GRAD_NORM:
        fail("%s: gradient cosine %.6f, norm off by %.4f" % (name, cos, dnorm))
    return cos, dnorm


def training_phases(kt, dev, card, reset_counts, counts):
    """Phase 4: the training path, its kernels and their gradients. Returns the
    ``gru_stack_hs`` entry of the kernels line and what the floor kernel showed
    on this path (launches, shape, error against its plain version, times)."""
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.ops.kernels import floor, gru
    from koala_tpu_torch.train import corpus
    from koala_tpu_torch.train.device_sampler import sample_from_tapes

    # the package re-exports the function ``train`` under the submodule's name
    trainer = importlib.import_module("koala_tpu_torch.train.train")
    cfg = dict(mask_gru_model.TRAIN_CONFIG)
    speech = corpus.build_speech_tape(101, 4)
    noise = corpus.build_noise_tape(202, 4)
    floor_tape = corpus.build_floor_tape(303, 4)
    print("tapes: speech %.1f s, noise %.1f s, floor %.1f s"
          % (len(speech) / 16e3, len(noise) / 16e3, len(floor_tape) / 16e3))

    # ---- main path: train_on_device from a seeded init
    trainer.train_on_device(speech, noise, steps=2, batch=TRAIN_B, segment_frames=TRAIN_T,
                            config=cfg, log_every=0, floor_tape=floor_tape)   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    log = io.StringIO()
    with Recorder(mask_gru_model, "gru_stack_trainable") as rec_hs, \
            Recorder(mask_gru_model, "floor_scan_trainable") as rec_fl, \
            contextlib.redirect_stdout(log):
        s = time.perf_counter()
        trained, trained_cfg = trainer.train_on_device(
            speech, noise, steps=TRAIN_STEPS, batch=TRAIN_B, segment_frames=TRAIN_T,
            config=cfg, log_every=1, seed=0, floor_tape=floor_tape)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - s
    train_counts = counts()
    losses = [float(v) for v in re.findall(r"loss (\S+)", log.getvalue())]
    print("path train_on_device: B=%d T=%d, %d steps, launches %s, %.3f s; loss %.4f -> %.4f"
          % (TRAIN_B, TRAIN_T, TRAIN_STEPS, train_counts, train_s, losses[0], losses[-1]))
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        fail("train_on_device: %d losses, not all finite: %s" % (len(losses), losses))
    if (train_counts["gru_stack_hs"], train_counts["floor_scan"]) != (TRAIN_STEPS, TRAIN_STEPS) \
            or train_counts["gru_stack"] or train_counts["engine_fused"]:
        fail("a train step must launch gru_stack_hs once, floor_scan once and nothing "
             "else: %s over %d steps" % (train_counts, TRAIN_STEPS))
    if any(p.requires_grad or not torch.isfinite(p).all() for p in trained.parameters()):
        fail("train_on_device returned weights that are not finite and frozen")

    # the trained (EMA) weights saved, loaded through the public surface, used
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trained.pv")
        params_io.save_params(path, trained, trained_cfg)
        tree, loaded_cfg = params_io.load_params(path)
        if loaded_cfg["snr_bands"] != 32 or not loaded_cfg["floor_feat"]:
            fail("saved model lost its config: %s" % loaded_cfg)
        pool = kt.create_batch(ACCESS_KEY, batch_size=4, model_path=path, device="gpu")
        pcm = mix_streams(40 * 256)[:4]
        out = pool.enhance(pcm)
        pool.delete()
    if out.shape != pcm.shape or np.all(out == 0):
        fail("the trained model's enhance output: shape %s" % (out.shape,))
    print("trained model: saved, loaded by create_batch, enhanced %s samples" % (out.shape,))

    # ---- one fixed batch through make_train_step: the loss falls
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    speech_d = torch.as_tensor(speech, device=dev)
    noise_d = torch.as_tensor(noise, device=dev)
    floor_d = torch.as_tensor(floor_tape, device=dev)
    noisy, clean = sample_from_tapes(speech_d, noise_d, gen, TRAIN_B, TRAIN_T * 256,
                                     floor_tape=floor_d)
    params = mask_gru_model.init_params(gen, cfg).requires_grad_(True)
    step = trainer.make_train_step(cfg, trainer.make_optimizer(params, 3e-4, 200))
    reset_counts()
    fixed = [float(step(params, noisy, clean)) for _ in range(10)]
    fixed_counts = counts()
    print("fixed batch, 10 steps of make_train_step: loss %.4f -> %.4f, launches %s"
          % (fixed[0], fixed[-1], fixed_counts))
    if not np.all(np.isfinite(fixed)) or not fixed[-1] < fixed[0]:
        fail("the loss on one fixed batch did not fall over 10 steps: %s" % fixed)
    if (fixed_counts["gru_stack_hs"], fixed_counts["floor_scan"]) != (10, 10):
        fail("make_train_step launches per step: %s over 10 steps" % fixed_counts)

    # ---- loss and gradients on the card against the port on the CPU
    params.requires_grad_(False)
    cpu_params = params_io.params_from_numpy(params_io.params_to_numpy(params), "cpu")
    loss_fn = trainer.make_loss_fn(cfg)
    both = {}
    for where, p, a, b in (("card", params, noisy, clean),
                           ("cpu", cpu_params, noisy.cpu(), clean.cpu())):
        p.requires_grad_(True)
        for q in p.parameters():
            q.grad = None
        loss = loss_fn(p, a, b)
        loss.backward()
        both[where] = (float(loss.detach()), [q.grad.detach().cpu() for q in p.parameters()])
    loss_rel = abs(both["card"][0] - both["cpu"][0]) / abs(both["cpu"][0])
    cosines = {name: cosine(g_card, g_cpu) for (name, _), g_card, g_cpu
               in zip(params.named_parameters(), both["card"][1], both["cpu"][1])}
    print("loss card %.5f vs CPU %.5f (rel %.2e); gradient cosines min %.6f (%s)"
          % (both["card"][0], both["cpu"][0], loss_rel, min(cosines.values()),
             min(cosines, key=cosines.get)))
    if loss_rel > LOSS_REL or min(cosines.values()) < LOSS_GRAD_COS:
        fail("loss or gradients on the card differ from the CPU: rel %.3e, cosines %s"
             % (loss_rel, cosines))

    # ---- the return_hidden kernel against the inference kernel and its plain version
    h0, xg, wx, bx, wh, bh = (t.detach() for t in rec_hs.args)
    g2 = torch.Generator(device=dev)
    g2.manual_seed(11)
    L, H = h0.shape[0], h0.shape[2]

    def random_inputs(b, t_len):
        return (torch.randn((L, b, H), generator=g2, device=dev) * 0.2,
                (torch.randn((t_len, b, H), generator=g2, device=dev) * 0.3).bfloat16())

    hs_err = 0.0
    for label, (hh, xx) in (("main path B=%d T=%d" % (xg.shape[1], xg.shape[0]), (h0, xg)),
                            ("recipe B=%d T=%d" % (RECIPE_B, RECIPE_T),
                             random_inputs(RECIPE_B, RECIPE_T)),
                            ("ragged B=40 T=24", random_inputs(40, 24))):
        y0, hf0 = gru.gru_stack(hh, xx, wx, bx, wh, bh)
        y1, hs1, hf1 = gru.gru_stack(hh, xx, wx, bx, wh, bh, return_hidden=True)
        ry, rhs, rhf = gru.gru_stack_ref(hh, xx, wx, bx, wh, bh, return_hidden=True)
        torch.cuda.synchronize()
        if not (torch.equal(y0, y1) and torch.equal(hf0, hf1)):
            fail("gru_stack_hs (%s): y or h_final differ from the inference kernel's" % label)
        if not torch.equal(hs1[-1], hf1):
            fail("gru_stack_hs (%s): hs[-1] is not h_final" % label)
        err = float((hs1 - rhs).abs().max())
        db = snr_db(rhs, hs1)
        hs_err = max(hs_err, err)
        print("gru_stack_hs %s: y, h_final bit-identical to gru_stack; hs max|err| %.4g "
              "(%.1f dB) against the plain version" % (label, err, db))
        if err > GRU_MAX_ABS or db < GRU_SNR_DB:
            fail("gru_stack_hs (%s) outside its tolerance against its plain version" % label)

    # ---- gru_stack_trainable (kernel forward, plain backward) against autograd
    #      through the plain version, on the main path's inputs
    ct_y = (torch.randn(xg.shape, generator=g2, device=dev)).bfloat16()
    ct_h = torch.randn(h0.shape, generator=g2, device=dev)

    def gru_grads(fn):
        ins = [t.clone().requires_grad_(True)
               for t in (h0, xg.float(), wx.float(), bx, wh.float(), bh)]
        y, hf = fn(ins[0], ins[1].bfloat16(), ins[2].bfloat16(), ins[3], ins[4].bfloat16(),
                   ins[5])
        ((y.float() * ct_y.float()).sum() + (hf * ct_h).sum()).backward()
        return [t.grad for t in ins]

    got, want = gru_grads(gru.gru_stack_trainable), gru_grads(gru.gru_stack_ref)
    agree = {n: grad_agreement("gru_stack_trainable " + n, a, b)
             for n, a, b in zip(("dh0", "dx", "dwx", "dbx", "dwh", "dbh"), got, want)}
    print("gru_stack_trainable against autograd through the plain version: "
          + ", ".join("%s cos %.6f norm %.1e" % (n, c, d) for n, (c, d) in agree.items()))

    # ---- the floor kernel against its plain version on the training path's inputs
    f0, lb, rise = rec_fl.args
    kf, kfl = floor.floor_scan(f0, lb, rise)
    rf, rfl = floor.floor_scan_ref(f0, lb, rise)
    torch.cuda.synchronize()
    floor_train = {
        "launches": train_counts["floor_scan"], "shape": list(lb.shape),
        "max_abs_err": max(float((kf - rf).abs().max()), float((kfl - rfl).abs().max())),
        "ms": time_ms(lambda: floor.floor_scan(f0, lb, rise), 50),
        "queued_ms": time_ms(lambda: floor.floor_scan(f0, lb, rise), 200, 5, queued=True),
        "plain_ms": time_ms(lambda: floor.floor_scan_ref(f0, lb, rise), 3, 1)}
    print("floor_scan on the training path, lb %s: %s its plain version (max|err| %.3g)"
          % (list(lb.shape), "bit-identical to" if torch.equal(kf, rf) and torch.equal(kfl, rfl)
             else "DIFFERS from", floor_train["max_abs_err"]))
    if not (torch.equal(kf, rf) and torch.equal(kfl, rfl)):
        fail("floor kernel differs from its plain version on the training path's inputs")

    # ---- floor_scan_trainable against autograd through the plain version
    ct_f = torch.randn(f0.shape, generator=g2, device=dev)
    ct_fl = torch.randn(lb.shape, generator=g2, device=dev)

    def floor_grads(fn):
        a, b = f0.clone().requires_grad_(True), lb.clone().requires_grad_(True)
        ff, fl = fn(a, b, rise)
        ((ff * ct_f).sum() + (fl * ct_fl).sum()).backward()
        return a.grad, b.grad

    got_f, want_f = floor_grads(floor.floor_scan_trainable), floor_grads(floor.floor_scan_ref)
    floor_exact = all(torch.equal(a, b) for a, b in zip(got_f, want_f))
    print("floor_scan_trainable against autograd through the plain version: dfloor0, dlb %s"
          % ("bit-identical" if floor_exact else "max|err| %.3g" % max(
              float((a - b).abs().max()) for a, b in zip(got_f, want_f))))
    if not floor_exact:
        fail("floor_scan_trainable's gradients differ from autograd's")
    floors = kfl
    floor_bwd_ms = time_ms(
        lambda: floor.floor_scan_backward(f0, lb, floors, rise, ct_f, ct_fl), 5, 1)

    # ---- times of a train step and its parts, at both shapes
    def step_times(b, t_len, reps=12):
        p = mask_gru_model.init_params(gen, cfg).requires_grad_(True)
        opt = trainer.make_optimizer(p, 3e-4, 1000)
        marks = {}
        orig_bwd = gru.gru_stack_backward

        def timed_bwd(*args):
            marks["g0"].record()
            out = orig_bwd(*args)
            marks["g1"].record()
            return out

        rows = []
        gru.gru_stack_backward = timed_bwd
        try:
            for i in range(reps + 2):
                for k in ("s0", "f0", "b0", "o0", "e", "g0", "g1"):
                    marks[k] = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                w = time.perf_counter()
                marks["s0"].record()
                a, c = sample_from_tapes(speech_d, noise_d, gen, b, t_len * 256,
                                         floor_tape=floor_d)
                marks["f0"].record()
                opt.zero_grad()
                loss = loss_fn(p, a, c)
                marks["b0"].record()
                loss.backward()
                marks["o0"].record()
                opt.step()
                marks["e"].record()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - w) * 1e3
                if i >= 2:                      # two warm-up steps
                    rows.append((wall, marks["s0"].elapsed_time(marks["f0"]),
                                 marks["f0"].elapsed_time(marks["b0"]),
                                 marks["b0"].elapsed_time(marks["o0"]),
                                 marks["g0"].elapsed_time(marks["g1"]),
                                 marks["o0"].elapsed_time(marks["e"])))
        finally:
            gru.gru_stack_backward = orig_bwd
        med = [statistics.median(col) for col in zip(*rows)]
        print("train step B=%d T=%d: %.2f ms (median of %d; sampler %.2f, forward %.2f, "
              "backward %.2f of which GRU backward %.2f and floor backward 0 (lb takes no "
              "gradient), optimizer %.2f), %.1f segments/s on %s"
              % (b, t_len, med[0], len(rows), med[1], med[2], med[3], med[4], med[5],
                 b / med[0] * 1e3, card))
        return med

    # each shape twice inside this one run (A, B, B, A): the step's host-bound
    # parts move between runs on a shared host, so its spread is read here
    for b, t_len in ((TRAIN_B, TRAIN_T), (RECIPE_B, RECIPE_T),
                     (RECIPE_B, RECIPE_T), (TRAIN_B, TRAIN_T)):
        step_times(b, t_len)
    print("floor backward (plain) alone, lb [%d, %d, %d] taking a gradient: %.3f ms on %s"
          % (*lb.shape, floor_bwd_ms, card))

    # ---- the gru_stack_hs entry: times and bound at the main path's shapes
    t_len, b, h = xg.shape
    g_bound = gru_bound(t_len, b, h, L, hidden_out=True)
    entry = {
        "name": "gru_stack_hs", "route": "cuda", "source": "koala_tpu_torch/csrc/gru.cu",
        "replaces": "koala_tpu/ops/pallas/gru.py:103", "variant": "return_hidden=True",
        "launches": train_counts["gru_stack_hs"], "max_abs_err": hs_err,
        "ms": time_ms(lambda: gru.gru_stack(h0, xg, wx, bx, wh, bh, return_hidden=True), 20, 2),
        "plain_ms": time_ms(lambda: gru.gru_stack_ref(h0, xg, wx, bx, wh, bh,
                                                      return_hidden=True), 2, 1),
        "bound_ms": max(g_bound.values()), "bound_by": max(g_bound, key=g_bound.get),
        "library_ms": time_ms(cudnn_gru_yardstick(xg, h0, training=True), 10),
        "shape": [t_len, b, h, L], **gru_launch_keys(gru, xg, L)}
    hr, xr = random_inputs(RECIPE_B, RECIPE_T)
    r_bound = gru_bound(RECIPE_T, RECIPE_B, h, L, hidden_out=True)
    r_keys = gru_launch_keys(gru, xr, L)
    print("gru_stack_hs at B=%d T=%d: %.3f ms (inference variant %.3f ms), bound_ms %.4f "
          "(%s), sequential floor %.4f ms (%d barriers, %d x %d blocks) on %s"
          % (RECIPE_B, RECIPE_T,
             time_ms(lambda: gru.gru_stack(hr, xr, wx, bx, wh, bh, return_hidden=True), 10, 2),
             time_ms(lambda: gru.gru_stack(hr, xr, wx, bx, wh, bh), 10, 2),
             max(r_bound.values()), max(r_bound, key=r_bound.get),
             r_keys["sequential_floor_ms"], r_keys["barriers"], *r_keys["grid"], card))
    ct_yr = torch.randn(xr.shape, generator=g2, device=dev).bfloat16()
    _, hsr, _ = gru.gru_stack(hr, xr, wx, bx, wh, bh, return_hidden=True)
    for label, args in (("B=%d T=%d" % (b, t_len), (h0, xg, wx, bx, wh, bh,
                                                   gru.gru_stack(h0, xg, wx, bx, wh, bh,
                                                                 return_hidden=True)[1],
                                                   ct_y, ct_h)),
                        ("B=%d T=%d" % (RECIPE_B, RECIPE_T),
                         (hr, xr, wx, bx, wh, bh, hsr, ct_yr, torch.zeros_like(hr)))):
        print("GRU backward (plain) at %s: %.2f ms on %s"
              % (label, time_ms(lambda: gru.gru_stack_backward(*args), 3, 1), card))
    return entry, floor_train


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

    counters = {"floor_scan": (floor, "launches"), "gru_stack": (gru, "launches"),
                "gru_stack_hs": (gru, "launches_hs"), "engine_fused": (engine_fused, "launches"),
                # the device launches that the fused calls made: five a segment
                "engine_fused_device": (engine_fused, "device_launches")}

    def reset_counts():
        for m, attr in counters.values():
            setattr(m, attr, 0)

    def counts():
        return {k: getattr(m, attr) for k, (m, attr) in counters.items()}

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
    # the device launches of enhance's own run: five stages for every segment
    fused_hops = rec_fused.args[2]
    fused_lay = engine_fused.Layout(rec_fused.args[3])
    fused_segments = -(-fused_hops.shape[1] // engine_fused.segment_hops(
        fused_hops.shape[0], engine_fused.frame_bytes(fused_lay.hidden, fused_lay.nbp)))
    if enh_counts["engine_fused"] != 1 or \
            enh_counts["engine_fused_device"] != len(engine_fused.STAGES) * fused_segments:
        fail("enhance should make one fused call of %d segment(s), %d device launches a "
             "segment: %s" % (fused_segments, len(engine_fused.STAGES), enh_counts))
    fused_device_launches = enh_counts["engine_fused_device"] // enh_counts["engine_fused"]
    if out_enh.shape != (B, n_enh):
        fail("enhance output shape %s" % (out_enh.shape,))
    # the same two streams through the port on the CPU (its float32 sequence path)
    cpu = kt.create_batch(ACCESS_KEY, batch_size=2, device="cpu")
    enh_cpu = cpu.enhance(pcm[:2, :n_enh])
    cpu.delete()
    enh_snr = [snr_db(enh_cpu[i].astype(np.float64), out_enh[i].astype(np.float64))
               for i in range(2)]
    print("enhance card vs CPU: %s dB" % ["%.2f" % v for v in enh_snr])
    if min(enh_snr) < CHUNK_SNR_DB:
        fail("enhance on the card is %.1f dB from the CPU" % min(enh_snr))
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
        # ms: a loop on an idle card, as for every row. At a few microseconds
        # of work that reads the host, so queued_ms (the calls wait behind a
        # spin kernel) stands beside it: the card's time
        "ms": time_ms(lambda: floor.floor_scan(f0, lb, rise), 50),
        "queued_ms": time_ms(lambda: floor.floor_scan(f0, lb, rise), 200, 5, queued=True),
        "plain_ms": time_ms(lambda: floor.floor_scan_ref(f0, lb, rise), 3, 1),
        "bound_ms": max(fl_bound.values()), "bound_by": max(fl_bound, key=fl_bound.get),
        "library_ms": None, "shape": [t_len, b, nb],
        # the bound is below what a launch takes: the time of a launch that
        # does nothing stands beside the row, timed the same two ways
        "empty_launch_ms": time_ms(lambda: floor.empty_launch(dev), 50),
        "empty_launch_queued_ms": time_ms(lambda: floor.empty_launch(dev), 200, 5, queued=True)})
    floor_shape_checks(floor, dev)

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
    g_bound = gru_bound(t_len, b, h, L, hidden_out=False)
    library_gru = cudnn_gru_yardstick(xg, h0, training=False)
    with torch.inference_mode():
        lib_ms = time_ms(library_gru, 10)
    kernels.append({
        "name": "gru_stack", "route": "cuda", "source": "koala_tpu_torch/csrc/gru.cu",
        "replaces": "koala_tpu/ops/pallas/gru.py:103", "launches": launches["gru_stack"],
        "max_abs_err": max(gy_err, gh_err),
        "ms": time_ms(lambda: gru.gru_stack(h0, xg, wx, bx, wh, bh), 20, 2),
        "plain_ms": time_ms(lambda: gru.gru_stack_ref(h0, xg, wx, bx, wh, bh), 2, 1),
        "bound_ms": max(g_bound.values()), "bound_by": max(g_bound, key=g_bound.get),
        "library_ms": lib_ms, "shape": [t_len, b, h, L], **gru_launch_keys(gru, xg, L)})
    gru_shape_checks(gru, _build.library(), dev, (wx, bx, wh, bh))

    # fused engine
    params, state, hops, cfg = rec_fused.args
    before = engine_fused.device_launches
    ks, ko = engine_fused.fused_sequence(params, state, hops, cfg)
    if engine_fused.device_launches - before != fused_device_launches:
        fail("the fused call on the recorded inputs made %d device launches, enhance's made %d"
             % (engine_fused.device_launches - before, fused_device_launches))
    ks2, ko2 = engine_fused.fused_sequence(params, state, hops, cfg)
    rs, ro = engine_fused.fused_sequence_ref(params, state, hops, cfg)
    t1 = (hops.shape[1] // 2) // 8 * 8
    sa, oa = engine_fused.fused_sequence(params, state, hops[:, :t1], cfg)
    sb, ob = engine_fused.fused_sequence(params, sa, hops[:, t1:], cfg)
    torch.cuda.synchronize()
    fz_snr = snr_db(ro, ko)
    fz_err = float((ko - ro).abs().max())
    print("fused: out %.1f dB against the plain version, max|err| %.4g" % (fz_snr, fz_err))
    if fz_snr < FUSED_SNR_DB:
        fail("fused engine kernels are %.1f dB from their plain version" % fz_snr)
    if not (torch.equal(ko, ko2) and fused_states_equal(ks, ks2)):
        fail("fused engine kernels: two launches on the same inputs differ")
    if not torch.equal(torch.cat([oa, ob], dim=1), ko):
        fail("fused engine kernels: chunked output differs from continuous")
    if not fused_states_equal(sb, ks):
        fail("fused engine kernels: chunked state differs from continuous")
    print("fused: chunked [0:%d]+[%d:%d] equals continuous, and launch equals launch, bit for "
          "bit" % (t1, t1, hops.shape[1]))
    fused_shape_checks(engine_fused, make_engine("mask_gru", cfg), params, cfg, dev)
    # the stages of the entry, by CUDA events inside it: the median of five calls
    stage_runs = []
    for _ in range(6):
        stage_ms = {}
        engine_fused.fused_sequence(params, state, hops, cfg, stage_ms=stage_ms)
        stage_runs.append(stage_ms)
    stages = {n: statistics.median(r[n] for r in stage_runs[1:]) for n in engine_fused.STAGES}
    print("fused stages at [%d, %d, 256] (ms, median of 5): %s; sum %.4f; %d device launches "
          "a call on %s" % (hops.shape[0], hops.shape[1],
                            ", ".join("%s %.4f" % kv for kv in stages.items()),
                            sum(stages.values()), fused_device_launches, card))
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
        "library_ms": None, "shape": [b, t_len, 256],
        "device_launches_per_call": fused_device_launches, "stage_ms": stages,
        # the GRU stage's chain of grid barriers: what the whole cannot go below
        **gru_launch_keys(gru, torch.empty((t_len, b, h), dtype=torch.bfloat16, device=dev), L)})

    # ---- 4. the training path, its kernel variant and its gradients
    hs_entry, floor_train = training_phases(kt, dev, card, reset_counts, counts)
    kernels.insert(2, hs_entry)
    # the floor kernel runs on two paths: the entry's own numbers are those of
    # process_chunk's shape, the training path's stand beside them
    kernels[0]["launches"] += floor_train["launches"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], floor_train["max_abs_err"])
    kernels[0]["launches_by_path"] = {"process_chunk": launches["floor_scan"],
                                      "train_on_device": floor_train["launches"]}
    kernels[0]["train_path"] = floor_train

    # ---- 5. end-to-end numbers of this run
    audio_s = B * n_enh / 16000.0
    print("enhance: %.1f audio-s/s (B=%d, %.2f s of audio each, %.4f s wall, first call) on %s"
          % (audio_s / enh_s, B, n_enh / 16000.0, enh_s, card))
    enh_again = []
    for _ in range(5):
        kb.reset()
        torch.cuda.synchronize()
        s = time.perf_counter()
        kb.enhance(pcm[:, :n_enh])
        enh_again.append(time.perf_counter() - s)
    print("enhance: median %.4f s, least %.4f s of 5 further calls (%.1f audio-s/s at the "
          "median), of which the fused engine's kernels %.4f s on %s"
          % (statistics.median(enh_again), min(enh_again),
             audio_s / statistics.median(enh_again), kernels[3]["ms"] / 1e3, card))
    print("process_chunk: %.1f audio-s/s (B=%d, T=%d, %.4f s wall, first call) on %s"
          % (B * n_chunk / 16000.0 / chunk_s, B, T, chunk_s, card))
    # the first call's wall time moves with the shared host: five more, each
    # on a reset pool, and the kernels' share of the median
    again_s = []
    for _ in range(5):
        kb.reset()
        torch.cuda.synchronize()
        s = time.perf_counter()
        kb.process_chunk(pcm[:, :n_chunk])
        again_s.append(time.perf_counter() - s)
    print("process_chunk: median %.4f s, least %.4f s of 5 further calls (%.1f audio-s/s at the "
          "median), of which the GRU kernel %.4f s and the floor kernel %.5f s on %s"
          % (statistics.median(again_s), min(again_s),
             B * n_chunk / 16000.0 / statistics.median(again_s), kernels[1]["ms"] / 1e3,
             kernels[0]["queued_ms"] / 1e3, card))
    lat_ms = np.asarray(lat) * 1e3
    print("process: per-frame p50 %.3f ms, p90 %.3f ms over %d frames on %s"
          % (np.percentile(lat_ms, 50), np.percentile(lat_ms, 90), len(lat_ms), card))
    for kr in kernels:
        print("kernel %-13s ms %.4f plain_ms %.4f library_ms %s bound_ms %.4f (%s)%s launches %d "
              "on %s" % (kr["name"], kr["ms"], kr["plain_ms"],
                         "%.4f" % kr["library_ms"] if kr["library_ms"] is not None else "null",
                         kr["bound_ms"], kr["bound_by"],
                         " sequential_floor_ms %.4f (%d barriers)"
                         % (kr["sequential_floor_ms"], kr["barriers"])
                         if "sequential_floor_ms" in kr else
                         " queued_ms %.4f empty_launch_ms %.4f (queued %.4f)"
                         % (kr["queued_ms"], kr["empty_launch_ms"],
                            kr["empty_launch_queued_ms"]),
                         kr["launches"], card))
    print("kernel floor_scan on the training path, lb %s: ms %.4f queued_ms %.4f plain_ms %.4f "
          "max|err| %g launches %d on %s"
          % (floor_train["shape"], floor_train["ms"], floor_train["queued_ms"],
             floor_train["plain_ms"], floor_train["max_abs_err"], floor_train["launches"], card))
    k.delete()
    kb.delete()

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
