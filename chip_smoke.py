"""Smoke run of koala_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

1. Builds the CUDA kernels from koala_tpu_torch/csrc with nvcc (sm_90a) and
   prints the build time, the card's name and its power limit.
2. Drives the port's main path on the bundled model through the public entry
   points, each path with the kernels' launch counters set to 0 just before
   it and read just after: ``Koala.process`` (per-frame: the GRU kernel at
   T = 1 and the fixed-order products), ``KoalaBatch.process_chunk`` (floor
   + GRU kernels) and ``KoalaBatch.enhance`` (the fused engine's kernels),
   every path's frame-local products through ``rowmm``, at B = 64 streams of
   6.0 s (T = 376 hops). Checks the delay contract, reset reproducing a fresh
   stream bit for bit, and ``process_chunk`` and ``enhance`` on the card
   against the port on the CPU for two streams (>= 35 dB). One stream's
   ``Koala.enhance`` over 6.0 s must launch the floor and GRU kernels once
   each (a batch of one) and call no plain version; it is held against the
   port on the CPU (>= 35 dB), its kernels against their plain versions on
   its inputs, and its time stands beside the scan branch's on the same
   input.
2c. Koala's acceptance gates (tests/test_parity.py's, with the ledger of
   tests/known_gaps.py, through scripts/train_model_torch.py's
   ``check_gates``) over the 7 committed held-out pairs x 3 cases (21
   streams of 365 frames) on four serving paths, each with the counters set
   to 0 just before it and read just after: ``KoalaBatch.process_chunk`` at
   B = 21 (floor + GRU kernels), ``KoalaBatch.enhance`` at B = 21 (the fused
   entry), ``Koala.enhance`` one stream at a time (floor + GRU at a batch of
   one) and ``KoalaBatch.process`` frame by frame (the eager step: the GRU
   kernel at T = 1). No plain version may run on any of them; each path's worst
   parity, lowest SI-SDR gain and worst STOI regression are printed beside
   the CPU port's ``evaluate``. With ``KOALA_REFERENCE_SAMPLES`` the
   reference pair and its 8 pseudo-real variants join the sets.
2d. The rest of the public surface, each part with its lines (``surface
   ...``): the mmse model (its STFT products through ``rowmm``, its gain
   recurrence through its own kernel, one launch a sequence call) through
   ``Koala.process``, ``Koala.enhance``, ``KoalaBatch.process``,
   ``process_chunk``, ``enhance`` (the mix at B = 64 and the battery at
   B = 21) and the StreamingServer (16 streams, backlog and live), each
   >= 35 dB from the port on the CPU with no kernel but ``rowmm`` and the
   gain kernel (once a sequence call) launched and no plain version called
   (a traced call's device launches printed, its port kernels those two's
   launches), timed, and the
   battery scored beside the CPU port's ``evaluate``; the identity model
   through ``create`` / ``create_batch`` (a 256-sample delay, and enhance
   the input itself, bit for bit, no kernel but ``rowmm``); snapshots cut at
   frame 192 for the
   bundled model and mmse at B = 21 and 64, after ``process_chunk`` and
   after ``enhance``, resumed in a fresh card instance (bit for bit), on the
   CPU and back on the card from the CPU's (>= 35 dB), the kernels held
   against their plain versions on the resumed halves' inputs; and the 21
   battery streams through ``scripts/serve_web_torch.py --device best`` over
   the WebSocket protocol, bit for bit a server's backlog run.
2e. A stream's output does not depend on how it is cut into calls (``cuts
   ...`` lines): the bundled model on the battery (B = 21 x 365) and on the
   mix (B = 64 x 376), and mmse on the battery, each held bit for bit to one
   ``process_chunk`` call over the whole streams: the StreamingServer's
   backlog in rounds of 32 and of 8 frames, its single-frame rounds (the
   captured step graph) and its live rounds (a frame a stream every 16 ms),
   T ``KoalaBatch.process`` calls, ``Koala.process`` frame by frame on 3 of
   the streams and one stream's ``Koala.enhance``. Each part prints, for
   each way, the largest difference in LSB and the samples that differ, the
   launches (an eager step launches the GRU kernel once where the model has
   a launch plan), no plain-version call, ``Koala.process`` p50 / p90 a
   frame, the server's live p50 / p90 and ``process_chunk``'s median time.
3. Holds each kernel against its plain PyTorch version on the card, on the
   inputs the main path gave it: floor bit-identical, GRU within its stated
   tolerance, fused >= 40 dB, chunked equal to continuous and launch equal to
   launch bit for bit. The floor kernel is also held bit-identical at a
   column count that is no multiple of 32, at T = 1 and over several slabs;
   the fused kernels against their plain version at B = 1, 17, 128, 300
   (T = 40), at T = 8, over two workspace segments, and at B = 512 x T = 64
   (the bench's batch, two segments), each from a state that is not zero.
   The GRU kernel is also held against its plain version at B = 1, 17, 128
   and 300, at H = 64 with one layer and H = 128 with three, at T = 0, and
   in its wider layouts: 512 x 3 in two layer groups, 256 x 17 in three with
   units spilled into shared memory;
   two launches must give the same bits, a sequence in two chunks the bits
   of one run, and the plan's shared-memory size must be the kernel's; on
   the step's inputs (``Koala.process``: T = 1, a batch of one) it is held
   and timed too, a loop of launches and queued behind a spin kernel.
   The fixed-order product ``rowmm`` is held on the inputs of each of the
   nine products of ``process_chunk``'s call (K and N of each), at M = 1,
   21, 64, 8 x 21, 365 x 21 and 376 x 64 rows and at its one-row kernels'
   limit and one row either side of it: bit for bit the first design's
   kernel (``rowmm_simple``, which no path launches), so within a relative
   1e-5 of its plain version, the decoder's and the gate's operand also as
   the call gave it (a permuted view, read in place), and a row must have
   the same bits at every M and at several places in a tile. Its times
   stand at M = 1 (the step, queued), 64 (a live round, queued) and
   376 x 64, each beside ``rowmm_simple``'s, ``torch.matmul``'s and the
   bound; at one row also the chain of K dependent FMAs a thread.
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
   call carries one-off host work).
6. Drives the serving plane, again with the counters set to 0 just before
   each run and read just after: ``StreamingServer`` (64 streams, chunks of
   8 frames) takes every stream's 6.0 s in one ``push_block`` (every round a
   full chunk: the floor and GRU kernels) and gives it back through
   ``pull_block``; frames per second, audio-s/s, the launches, and the
   output against ``process_chunk`` on the card and the port on the CPU
   (>= 35 dB). Then the same 64 streams live, one frame each every 16 ms for
   3 s (single-frame rounds): push-to-pull latency p50 and p90 (p50 below
   16 ms), and a stream reset mid-run that lets no pre-reset audio through.
   Then one round trip of 128 frames through ``scripts/serve_tcp_torch.py
   --device gpu`` as a subprocess, from Python and from the C client demo
   (``demo/c/koala_client_demo.c``, built with gcc): each aligned 1:1 and
   within 2 LSB of the backlog run.
7. Drives the parallel layer: ``CorpusRunner`` on a mesh of one card at
   B = 64 x 6.0 s (the fused engine; bit-identical to
   ``Engine.sequence_fast``; audio-s/s of a wash), and the data-parallel
   ``make_train_step(mesh=...)`` under a one-rank NCCL group at
   ``TRAIN_CONFIG``, B = 64 x 63: loss and weights after one step
   bit-identical to the unsharded step, and its time.
8. Runs ``bench_torch.py``'s phases in this process, again with the counters
   set to 0 just before and read just after: the engine number through
   ``Engine.sequence_fast`` at B = 512 x T = 376 (the fused entry, which must
   make 35 device launches a call: 7 workspace segments of 5 stages), 5 timed
   calls; the StreamingServer at 128 streams, chunks of 64, for 2 s, and its
   latency at 25/50/100% occupancy; the PCIe link; one stream's step, its
   device time from a CUDA graph of chained steps. Prints bench.py's record
   as its own JSON line. Then ``scripts/bench_sweep_torch.py``'s sections 1
   and 1b at B = 512 x 376 (``sequence``, ``sequence_fast`` by stage, the
   GRU kernel alone and their bounds; the no-tracker ablation, STFT + iSTFT,
   the floor kernel alone) and ``scripts/pod_wash_torch.py`` on the card's
   one-device mesh, each record on a line of its own; the floor and GRU
   kernels are held against their plain versions on the inputs each of the
   two gave them (the unfused ``sequence`` at B = 512 x 376, the wash's tail
   hops after its fused segments), as on the server's backlog round and the
   bench's first serving round.
9. The gate of the GRU kernel: seeded ``init_params`` models run
   ``KoalaBatch.process_chunk`` and ``enhance`` at B = 64 x 64 hops on the
   card, >= 35 dB from the port on the CPU. Hidden 384 x 2 and 512 x 3 (two
   layer groups) have a launch plan: the GRU kernel and the fused entry
   launch. Hidden 768 x 3 has none, nor does koala_tpu's kernel take it: no
   raise, the floor kernel launched and the GRU kernel not, one warning.
   512 x 3 and 768 x 3 also take one ``train_on_device`` step at B = 8, the
   first through the GRU kernel's ``return_hidden`` variant.
10. ``demo/koala_demo_file_torch.py --device gpu`` as a subprocess on the
   repository's 5.9 s dev mix: >= 35 dB from the same demo with ``--device
   cpu``, and its real-time factor.
11. ``scripts/make_corpus_torch.py`` (small tapes, the whole dev battery)
   and ``scripts/make_fixtures_torch.py`` into a temporary directory, twice:
   byte-identical runs, every WAV 93680 samples.
12. FullSubNet (``models/fullsubnet/fullsubnet_random.pv``) and its LSTM-cell kernel
   (``csrc/lstm.cu``): the kernel against its plain version at each of the
   model's four widths and at Demucs's (kx = H = 1024, depth 2048 in
   K-panels) at 1, 64, 127, 128, 129, 257 and the benchmark's rows
   (2048 for the full band and Demucs, 526,336 for the sub-band) and 29 fewer, a row's
   bits the same at every row count, and each width's launch plan and time
   beside its bound, its plain version's and the library's (a ``lstm ...``
   line each); one stream's ``Koala.process``
   bit for bit its row of ``CorpusRunner.enhance_batch`` at B = 64; the
   ``StreamingServer`` bit for bit ``Koala.process``; ``mask_gru`` and
   ``mmse`` with their masks handed over as (mask, 0) bit for bit as real
   masks; a ``{"fullsubnet": ...}`` JSON line.
12b. The mmse gain kernel (``csrc/mmse.cu``) bit for bit its plain version,
   masks and every state leaf, at the corpus wash's [8192, 375, 257] and
   ``process_chunk``'s [64, 376, 257], with its time beside its bound and
   the plain loop's (``scripts/mmse_times_torch.py``): a ``mmse_gain ...``
   line a shape and a ``{"mmse_gain": ...}`` JSON line; then
   ``CorpusRunner.enhance_batch`` with ``mmse`` (64 streams of 375 frames,
   the counts reset before it): one gain launch a batch, ``rowmm``, no other
   kernel and no plain version, bit for bit the batch with the plain version
   in the kernel's place (a ``mmse_gain corpus runner`` line).
12c. Demucs (``models/demucs.py``) at dns64's widths, its weights drawn from
   the benchmark configuration's seed: ``CorpusRunner.enhance_batch`` at the
   cell's 2048 x 375 hops (the counts reset just before it): 750 LSTM
   launches (two a hop), 1175 ``rowmm`` launches of which 705 of its fused
   entry (15 a block of 8 hops, 47 blocks), 235 overlap passes (5 a block),
   no other kernel and no plain version; the same batch through the plain
   U-Net (``_encoder_plain``, ``_decoder_plain``) bit for bit; two streams'
   ``Koala.process`` bit for bit their rows, 15 fused launches (the narrow
   kernels) and 5 overlap passes a hop, no plain version (a ``demucs corpus
   runner`` line); each of a block's 15 fused products and 5 overlap passes
   at 2048 x 8 hops bit for bit its plain version, timed beside its bound
   and the plain version (a ``demucs <product>`` line each).
13. Prints one ``{"kernels": [...]}`` line (nine entries: each kernel's
   launches by path and in all; ``rowmm``'s times are the sum over the nine
   products at 376 x 64 rows, beside ``rowmm_simple``'s and
   ``torch.matmul``'s, with the same at 64 rows and one, and
   ``bits_equal_simple``; ``lstm_cell``'s the sum over a frame's four
   layer-steps at B = 2048, with Demucs's hop of two beside it and its
   launches on the Demucs paths; ``mmse_gain``'s at [8192, 375, 257];
   ``rowmm_fused``'s and ``overlap_add``'s the sums over a block's fused
   products and overlap passes at 2048 x 8 hops, their launches on the
   Demucs paths), the
   card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero. Without a CUDA card, or without the
repository beside it, it exits nonzero before printing a result.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import importlib.util
import io
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

B, T = 64, 376                 # streams, hops per stream (6.0 s of audio)
PROCESS_FRAMES = 300           # per-frame Koala.process calls
ACCESS_KEY = "SMOKETEST0=="
GRU_SNR_DB = 40.0              # GRU y against its plain version
GRU_MAX_ABS = 0.1              # ... and h_final / y max |err| (bf16 flips, 376 steps)
FUSED_SNR_DB = 40.0
FUSED_FLOOR_ABS = 2e-2         # a flipped bf16 rounding of a band power moves its log by 2**-8
CHUNK_SNR_DB = 35.0
# the acceptance phase: a path's largest difference from the CPU port's
# evaluate over the battery, in (worst parity, SI-SDR gain dB, STOI
# regression). The delayed and the single-stream paths take the tolerances of
# tests/test_torch_parity.py's surface test on the CPU; the fused enhance's
# bf16 spectral rounding shows in its plain version too (5.4e-4, 0.107 dB,
# 0.0066 on the card), held to the figures predicted for it before it ran
CPU_DIFF_LIMIT = {"process_chunk": (1e-4, 0.05, 1e-3), "process": (1e-4, 0.05, 1e-3),
                  "Koala.enhance": (2e-4, 0.05, 2e-3), "enhance": (8e-4, 0.15, 1e-2)}
TRAIN_B, TRAIN_T = 64, 63      # train_on_device's own defaults
RECIPE_B, RECIPE_T = 128, 125  # the training script's recipe
TRAIN_STEPS = 20
GRAD_COS = 0.999               # kernel-forward gradients against autograd through the
GRAD_NORM = 0.02               # plain version: per-leaf cosine and relative norm
LOSS_REL = 1e-3                # loss on the card against the port on the CPU
LOSS_GRAD_COS = 0.99           # ... and its per-leaf gradient cosine
SERVE_CHUNK = 8                # the server's backlog rounds: 376 = 47 full chunks
LIVE_S = 3.0                   # live cadence: one frame a stream every 16 ms
TCP_FRAMES = 128               # the TCP round trip: 2.048 s, 16 full chunks
BENCH_B, BENCH_ITERS = 512, 5  # bench_torch's default batch, fewer timed calls
BENCH_SERVE = dict(serve_streams=128, serve_secs=2.0, serve_chunk=64)
# 7 workspace segments (segment_hops(512, frame_bytes(384, 32)) = 58 hops) of 5 stages
BENCH_FUSED_LAUNCHES = 35
GATE_B, GATE_T = 64, 64        # the gate phase's process_chunk
SINGLE_N = 6 * 16000           # one stream's Koala.enhance: the 6.0 s mix, 376 hops
SWEEP_ITERS = 3                # bench_sweep_torch.py's sections 1 and 1b: timed calls
POD_WASH_ARGS = ["--utterances", "256", "--utterance-seconds", "6.0"]   # 4 batches of 64
# (hidden, layers, has a GRU launch plan, one train step) of the gate phase
GATE_MODELS = ((384, 2, True, False), (512, 3, True, True), (768, 3, False, True))
SURFACE_REPS = 5               # the surface phase's timed calls, after one to warm up
SURFACE_CUT = 192              # its snapshots' cut, in frames (a multiple of 8: enhance's plan)
SURFACE_SERVER_STREAMS = 16    # its mmse server's streams
SURFACE_LIVE_S = 2.0           # ... and their live cadence
# the WebSocket replies against a server's backlog run, in LSB: the front's
# rounds fall as its clients' messages arrive, and a stream's output does
# not depend on how it is cut into rounds (the cuts phase)
WS_LSB = 0
# the fixed-order product against its plain version: max |diff| over the
# largest element of the plain result (float32 sums of up to 512 products in
# another order)
ROWMM_REL = 1e-5
# the rows at which it is held (and at rowmm.ROW_MAX and either side of it):
# one stream's frame, the battery's 21 streams, the main path's 64, a round
# of 8 frames of the battery, the battery's 365 frames in one call, the main
# path's 376 x 64
ROWMM_ROWS = (1, 21, 64, 8 * 21, 365 * 21, 376 * 64)
# (K, N) of the nine products of a process_chunk call, in their order
ROWMM_SITES = (("stft_re", 512, 257), ("stft_im", 512, 257), ("band", 257, 32),
               ("cep", 257, 161), ("encoder", 329, 384), ("decoder", 384, 257),
               ("gate", 384, 1), ("istft_re", 257, 512), ("istft_im", 257, 512))
CUTS_STREAMS = 3               # the cuts phase's Koala.process streams
CUTS_LIVE_S = 2.0              # ... and its servers' live cadence
CUTS_CHUNK_REPS = 5            # ... and its timed process_chunk calls


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

    def record(self, args):
        if self.args is None:
            self.args = clone(args)

    def __enter__(self):
        def wrapped(*args, **kwargs):
            self.record(args)
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class RecordAll(Recorder):
    """A ``Recorder`` that keeps a copy of the arguments of every call."""

    def __enter__(self):
        self.calls = []
        return super().__enter__()

    def record(self, args):
        self.calls.append(clone(args))


class CallCount(Recorder):
    """A ``Recorder`` that only counts the calls."""

    calls = 0

    def record(self, args):
        self.calls += 1


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
    from koala_tpu_torch.profiling import time_ms

    plan = gru.plan_for(x, layers)
    n = plan.barriers(x.shape[0])
    return {"sequential_floor_ms": time_ms(lambda: gru.grid_barriers(plan, n, x.device), 10),
            "barriers": n, "grid": [plan.groups, plan.slices], "blocks": plan.blocks,
            "layer_groups": plan.layer_groups, "spilled_units": plan.spilled_units,
            "slice_width": plan.slice_width, "chunk_rows": plan.chunk_rows,
            "passes": plan.passes, "smem_bytes": plan.smem_bytes}


def gru_shape_checks(gru, lib, dev, weights):
    """The GRU kernel against its plain version away from the main path's
    shape: ragged, single-row and many-pass batches at the model's width
    (``weights``: its stacked wx, bx, wh, bh), narrow stacks of one and three
    layers on seeded random weights, T = 0; both variants each time. Then
    chunked against continuous and launch against launch, bit for bit."""
    from koala_tpu_torch.profiling import time_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def random_weights(h, layers, gain=1.5):
        return ((randn(layers, h, 3 * h) * (gain / h ** 0.5)).bfloat16(), randn(layers, 3 * h) * 0.1,
                (randn(layers, h, 3 * h) * (gain / h ** 0.5)).bfloat16(), randn(layers, 3 * h) * 0.1)

    model_h, model_layers = weights[0].shape[1], weights[0].shape[0]
    cases = [(12, 1, model_h, model_layers, weights), (9, 17, model_h, model_layers, weights),
             (8, 128, model_h, model_layers, weights), (6, 300, model_h, model_layers, weights),
             (0, 5, model_h, model_layers, weights),
             (16, 40, 64, 1, random_weights(64, 1)), (16, 64, 128, 3, random_weights(128, 3)),
             (5, 300, 128, 3, random_weights(128, 3)),
             # two layer groups; three with units spilled into shared memory (a
             # contractive gain: deeper random stacks amplify a rounding flip)
             (9, 64, 512, 3, random_weights(512, 3)), (6, 8, 256, 17, random_weights(256, 17, 0.5))]
    for t_len, b, h, layers, w in cases:
        h0, x = randn(layers, b, h) * 0.2, (randn(t_len, b, h) * 0.3).bfloat16()
        plan = gru.plan_for(x, layers)
        theirs = lib.koala_gru_smem_bytes(h, plan.block_layers, plan.slice_width, plan.chunk_rows)
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
        print("gru T=%d B=%d H=%d L=%d (%d x %d x %d blocks, %d spilled units, %d rows a chunk, "
              "%d pass%s): y max|err| %.4g (%.1f dB), h_final %.4g, hs %.4g"
              % (t_len, b, h, layers, plan.groups, plan.layer_groups, plan.slices,
                 plan.spilled_units, plan.chunk_rows, plan.passes,
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
    # the two-layer-group layout at the main path's T and B: its time beside its bound
    h, layers = 512, 3
    w = random_weights(h, layers)
    h0, x = randn(layers, B, h) * 0.2, (randn(T, B, h) * 0.3).bfloat16()
    ms = time_ms(lambda: gru.gru_stack(h0, x, *w), 10)
    bound = gru.bound(T, B, h, layers, hidden_out=False)
    keys = gru_launch_keys(gru, x, layers)
    print("gru wide layout H=%d L=%d at T=%d B=%d (%d layer groups, %d blocks, %d passes): "
          "ms %.4f bound_ms %.4f (%s) sequential_floor_ms %.4f (%d barriers) on %s"
          % (h, layers, T, B, keys["layer_groups"], keys["blocks"], keys["passes"], ms,
             max(bound.values()), max(bound, key=bound.get), keys["sequential_floor_ms"],
             keys["barriers"], card_line()))


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


def hold_fused(path, args):
    """The fused kernels against their plain version on the inputs ``args``
    (params, state, hops, cfg) that ``path`` gave the fused entry: the output
    within ``FUSED_SNR_DB``, the state's GRU h within ``GRU_MAX_ABS``, its
    floor within ``FUSED_FLOOR_ABS`` and its overlap-add tail within 1e-2.
    Returns the kernels' state and output, and what the check showed."""
    from koala_tpu_torch.ops.kernels import engine_fused

    if args is None:
        fail("%s made no call to the fused entry" % path)
    params, state, hops, cfg = args
    ks, ko = engine_fused.fused_sequence(params, state, hops, cfg)
    rs, ro = engine_fused.fused_sequence_ref(params, state, hops, cfg)
    torch.cuda.synchronize()
    db = snr_db(ro, ko)
    err = float((ko - ro).abs().max())
    errs = {"ola": float((ks["ola"] - rs["ola"]).abs().max()),
            "h": float((ks["model"]["h"] - rs["model"]["h"]).abs().max()),
            "floor": float((ks["model"]["floor"] - rs["model"]["floor"]).abs().max())}
    print("fused %s: hops %s, out %.1f dB, max|err| %.3g; state max|err| ola %.3g, h %.3g, "
          "floor %.3g" % (path, list(hops.shape), db, err, errs["ola"], errs["h"], errs["floor"]))
    if not torch.isfinite(ko).all() or db < FUSED_SNR_DB:
        fail("fused kernels are %.1f dB from their plain version on %s" % (db, path))
    if errs["h"] > GRU_MAX_ABS or errs["floor"] > FUSED_FLOOR_ABS or errs["ola"] > 1e-2:
        fail("fused kernels' state outside its tolerance on %s: %s" % (path, errs))
    return ks, ko, {"shape": list(hops.shape), "max_abs_err": err, "snr_db": db,
                    "state_max_abs_err": errs}


def fused_shape_checks(engine_fused, engine, params, cfg, dev):
    """The fused kernels against their plain version away from the main
    path's shape: single-stream, ragged, wide and many-pass batches at
    T = 40, T = 8, a T that crosses a workspace segment, and the bench's
    batch B = 512 over two segments; each from the state that eight hops
    leave behind (nothing of it zero)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    lay = engine_fused.Layout(cfg)
    per_frame = engine_fused.frame_bytes(lay.hidden, lay.nbp)
    crossing = engine_fused.segment_hops(300, per_frame) + 5
    for b, t_len in ((1, 40), (17, 40), (128, 40), (300, 40), (64, 8), (300, crossing),
                     (512, 64)):
        hops = torch.randn((b, t_len + 8, 256), generator=gen, device=dev) * 0.05
        state, _ = engine_fused.fused_sequence(params, engine.init_state((b,), dev),
                                               hops[:, :8], cfg)
        hops = hops[:, 8:].contiguous()
        segments = -(-t_len // engine_fused.segment_hops(b, per_frame))
        before = engine_fused.device_launches
        ks, ko, _ = hold_fused("B=%d T=%d (%d segment%s)"
                               % (b, t_len, segments, "" if segments == 1 else "s"),
                               (params, state, hops, cfg))
        if engine_fused.device_launches - before != len(engine_fused.STAGES) * segments:
            fail("fused B=%d T=%d: %d device launches for %d segment(s)"
                 % (b, t_len, engine_fused.device_launches - before, segments))
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


def gru_step_hold(gru, args, card):
    """The GRU kernel on the inputs of the step's first launch (``Koala.process``:
    x [1, 1, H], a batch of one), against its plain version (within
    ``GRU_MAX_ABS``), and its time a launch: a loop on an idle card and
    queued behind a spin kernel (the card's time)."""
    from koala_tpu_torch.profiling import time_ms

    h0, x, wx, bx, wh, bh = args
    with torch.inference_mode():
        ky, kh = gru.gru_stack(h0, x, wx, bx, wh, bh)
        ry, rh = gru.gru_stack_ref(h0, x, wx, bx, wh, bh)
        torch.cuda.synchronize()
        err = max(float((ky.float() - ry.float()).abs().max()), float((kh - rh).abs().max()))
        if err > GRU_MAX_ABS:
            fail("GRU kernel at T = 1 is %g from its plain version on the step's inputs" % err)
        held = {"shape": list(x.shape) + [h0.shape[0]], "max_abs_err": err,
                "ms": time_ms(lambda: gru.gru_stack(h0, x, wx, bx, wh, bh), 50),
                "queued_ms": time_ms(lambda: gru.gru_stack(h0, x, wx, bx, wh, bh), 50, 5,
                                     queued=True)}
    print("gru at the step's shape x %s (Koala.process): max|err| %.4g from its plain version; "
          "%.4f ms a launch, %.4f ms queued on %s"
          % (list(x.shape), err, held["ms"], held["queued_ms"], card))
    return held


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock (MHz), as nvidia-smi reports it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail("nvidia-smi failed: " + r.stderr.strip())
    return float(r.stdout.strip().splitlines()[0])


def rowmm_hold(rowmm, calls, card):
    """The fixed-order product on the inputs of the nine products of one
    process_chunk call (``calls``, in ``ROWMM_SITES``' order), at each of
    ``ROWMM_ROWS``' row counts and at the one-row kernel's limit and one row
    either side of it: bit for bit the first design's kernel
    (``rowmm_simple``), and so within ``ROWMM_REL`` of its plain version;
    the decoder's and the gate's operand also as the call gave it (a
    permuted view, read in place); a row's bits the same at every row count
    and at several places in a tile. Times the nine at the call's rows, at
    64 rows (the live round) and at one (the step): the kernel that the plan
    picks, rowmm_simple, the plain version (at the call's rows) and
    ``torch.matmul`` (cuBLAS, the same function, used nowhere in the port),
    each the sum over the nine, and their bound; at 64 and one row queued
    behind a spin kernel (the card's time). At one row the bound is B's
    bytes, and the chain of K dependent FMAs a thread (4 cycles each at the
    card's highest clock) stands beside it. Returns the kernel's entry of the
    ``{"kernels": ...}`` line."""
    from koala_tpu_torch.profiling import time_ms

    if [tuple(b.shape) for _, b in calls] != [(k, n) for _, k, n in ROWMM_SITES]:
        fail("process_chunk's products were %s, not %s"
             % ([tuple(b.shape) for _, b in calls], [s[1:] for s in ROWMM_SITES]))
    if rowmm.variants_on_card() != [v[1:] for v in rowmm.VARIANTS]:
        fail("rowmm: the card's variants %s are not the plan's %s"
             % (rowmm.variants_on_card(), [v[1:] for v in rowmm.VARIANTS]))
    held_rows = sorted(set(ROWMM_ROWS) | {rowmm.ROW_MAX - 1, rowmm.ROW_MAX, rowmm.ROW_MAX + 1})
    clock = max_sm_clock_mhz()
    sites, rel, err = {}, 0.0, 0.0
    for (name, k, n), (a_in, b) in zip(ROWMM_SITES, calls):
        a = a_in.reshape(-1, k)
        m_all = a.shape[0]
        with torch.inference_mode():
            full = rowmm.rowmm(a, b)
            as_given = rowmm.rowmm(a_in, b).reshape(-1, n)
            if not torch.equal(as_given, full):
                fail("rowmm %s: the operand as the call gave it (strides %s) differs from its "
                     "contiguous copy" % (name, a_in.stride()))
            for m in held_rows:
                part = a[:m]
                got, want = rowmm.rowmm(part, b), rowmm.rowmm_ref(part, b)
                simple = rowmm.rowmm_simple(part, b)
                torch.cuda.synchronize()
                if not torch.equal(got, simple):
                    fail("rowmm %s at M = %d (%s) differs from rowmm_simple"
                         % (name, m, rowmm.plan(m, n, k).name))
                diff = float((got - want).abs().max())
                rel = max(rel, diff / max(float(want.abs().max()), 1e-30))
                err = max(err, diff)
                for start in (0, 5, 63, 81, m_all - m):
                    if start + m <= m_all and not torch.equal(
                            rowmm.rowmm(a[start:start + m].contiguous(), b),
                            full[start:start + m]):
                        fail("rowmm %s: rows %d:%d of a call of %d rows differ from the same "
                             "rows of a call of %d" % (name, start, start + m, m, m_all))
        if rel > ROWMM_REL:
            fail("rowmm %s is %.3g from its plain version (relative; limit %g)"
                 % (name, rel, ROWMM_REL))
        bound, bound64, bound1 = (rowmm.bound(m, k, n) for m in (m_all, 64, 1))
        a64, a1 = a[:64].contiguous(), a[:1].contiguous()
        with torch.inference_mode():
            sites[name] = {
                "shape": [m_all, k, n],
                "plans": {str(m): rowmm.plan(m, n, k).name for m in (1, 64, m_all)},
                "ms": time_ms(lambda: rowmm.rowmm(a, b), 20),
                "simple_ms": time_ms(lambda: rowmm.rowmm_simple(a, b), 20),
                "plain_ms": time_ms(lambda: rowmm.rowmm_ref(a, b), 2, 1),
                "library_ms": time_ms(lambda: torch.matmul(a, b), 20),
                "bound_ms": max(bound.values()), "bytes_ms": bound["bytes"],
                "operations_ms": bound["operations"],
                "rows_64_queued_ms": time_ms(lambda: rowmm.rowmm(a64, b), 50, 5, queued=True),
                "rows_64_simple_queued_ms": time_ms(lambda: rowmm.rowmm_simple(a64, b), 50, 5,
                                                    queued=True),
                "rows_64_library_queued_ms": time_ms(lambda: torch.matmul(a64, b), 50, 5,
                                                     queued=True),
                "rows_64_bound_ms": max(bound64.values()),
                "one_row_queued_ms": time_ms(lambda: rowmm.rowmm(a1, b), 50, 5, queued=True),
                "one_row_simple_queued_ms": time_ms(lambda: rowmm.rowmm_simple(a1, b), 50, 5,
                                                    queued=True),
                "one_row_library_queued_ms": time_ms(lambda: torch.matmul(a1, b), 50, 5,
                                                     queued=True),
                "one_row_bound_ms": max(bound1.values()),
                "one_row_chain_ms": rowmm.chain_ms(k, clock)}
    keys = ("ms", "simple_ms", "plain_ms", "library_ms", "bytes_ms", "operations_ms",
            "rows_64_queued_ms", "rows_64_simple_queued_ms", "rows_64_library_queued_ms",
            "rows_64_bound_ms", "one_row_queued_ms", "one_row_simple_queued_ms",
            "one_row_library_queued_ms", "one_row_bound_ms", "one_row_chain_ms")
    total = {key: sum(v[key] for v in sites.values()) for key in keys}
    m_all = calls[0][0].reshape(-1, 512).shape[0]
    print("rowmm: bit-identical to rowmm_simple at M = %s on the nine products of process_chunk "
          "(and on the decoder's and the gate's permuted operands as given), within %.3g "
          "(relative) of its plain version (largest |diff| %.3g); a row's bits the same at every "
          "M and place in a tile" % (held_rows, rel, err))
    print("rowmm: the nine at M = %d: %.4f ms (rowmm_simple %.4f, plain %.4f, torch.matmul %.4f, "
          "bound %.4f ms); at M = 64 queued %.4f ms (rowmm_simple %.4f, torch.matmul %.4f, bound "
          "%.4f); at M = 1 (the step) queued %.4f ms (rowmm_simple %.4f, torch.matmul %.4f; bound "
          "%.4f ms by bytes, chain of sum K = %d FMAs %.4f ms at %.0f MHz) on %s"
          % (m_all, total["ms"], total["simple_ms"], total["plain_ms"], total["library_ms"],
             max(total["bytes_ms"], total["operations_ms"]), total["rows_64_queued_ms"],
             total["rows_64_simple_queued_ms"], total["rows_64_library_queued_ms"],
             total["rows_64_bound_ms"], total["one_row_queued_ms"],
             total["one_row_simple_queued_ms"], total["one_row_library_queued_ms"],
             total["one_row_bound_ms"], sum(k for _, k, _ in ROWMM_SITES),
             total["one_row_chain_ms"], clock, card))
    for name, v in sites.items():
        print("  rowmm %-8s [%d, %d] @ [%d, %d]: %s %.4f ms (simple %.4f, torch.matmul %.4f, "
              "bound %.4f); 64 rows %s %.4f (simple %.4f, torch.matmul %.4f); one row %s %.4f "
              "(simple %.4f, torch.matmul %.4f) queued"
              % (name, v["shape"][0], v["shape"][1], v["shape"][1], v["shape"][2],
                 v["plans"][str(v["shape"][0])], v["ms"], v["simple_ms"], v["library_ms"],
                 v["bound_ms"], v["plans"]["64"], v["rows_64_queued_ms"],
                 v["rows_64_simple_queued_ms"], v["rows_64_library_queued_ms"],
                 v["plans"]["1"], v["one_row_queued_ms"], v["one_row_simple_queued_ms"],
                 v["one_row_library_queued_ms"]))
    return {
        "name": "rowmm", "route": "cuda", "source": "koala_tpu_torch/csrc/rowmm.cu",
        "replaces": "none: the jnp matmuls outside any Pallas kernel "
                    "(koala_tpu/ops/stft.py:138, koala_tpu/models/mask_gru.py:205)",
        "launches": 0, "max_abs_err": err, "max_rel_err": rel, "bits_equal_simple": True,
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": max(total["bytes_ms"], total["operations_ms"]),
        "bound_by": "bytes" if total["bytes_ms"] > total["operations_ms"] else "operations",
        "library_ms": total["library_ms"], "simple_ms": total["simple_ms"],
        "shape": [v["shape"] for v in sites.values()],
        **{key: total[key] for key in keys if key.startswith(("rows_64", "one_row"))},
        "sm_clock_mhz": clock, "held_at_rows": held_rows, "sites": sites}


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
    from koala_tpu_torch.profiling import time_ms
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
    g_bound = gru.bound(t_len, b, h, L, hidden_out=True)
    entry = {
        "name": "gru_stack_hs", "route": "cuda", "source": "koala_tpu_torch/csrc/gru.cu",
        "replaces": "koala_tpu/ops/pallas/gru.py:104", "variant": "return_hidden=True",
        "launches": train_counts["gru_stack_hs"], "max_abs_err": hs_err,
        "ms": time_ms(lambda: gru.gru_stack(h0, xg, wx, bx, wh, bh, return_hidden=True), 20, 2),
        "plain_ms": time_ms(lambda: gru.gru_stack_ref(h0, xg, wx, bx, wh, bh,
                                                      return_hidden=True), 2, 1),
        "bound_ms": max(g_bound.values()), "bound_by": max(g_bound, key=g_bound.get),
        "library_ms": time_ms(cudnn_gru_yardstick(xg, h0, training=True), 10),
        "shape": [t_len, b, h, L], **gru_launch_keys(gru, xg, L)}
    hr, xr = random_inputs(RECIPE_B, RECIPE_T)
    r_bound = gru.bound(RECIPE_T, RECIPE_B, h, L, hidden_out=True)
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


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def pull_all(srv, n_streams, frames, deadline_s=120.0):
    """Pull ``frames`` enhanced frames of every stream from a server."""
    got = np.zeros((n_streams, frames, 256), np.int16)
    have = np.zeros(n_streams, np.int64)
    deadline = time.time() + deadline_s
    while have.sum() < n_streams * frames and time.time() < deadline:
        rows, cnt = srv.pull_block(frames)
        if not cnt.any():
            time.sleep(0.0005)
            continue
        for i in np.nonzero(cnt)[0]:
            c = min(int(cnt[i]), frames - int(have[i]))
            got[i, have[i]:have[i] + c] = rows[i, :c]
            have[i] += c
    if have.sum() < n_streams * frames:
        fail("the server gave %d of %d frames within %.0f s"
             % (have.sum(), n_streams * frames, deadline_s))
    return got


class PlainCalls:
    """Counts the calls of the kernels' plain versions (the floor's, the
    GRU's with the scan branch's step, the fused entry's, the fixed-order
    product's and its fused entry's, the overlap pass's, the mmse gain
    recurrence's, the LSTM cell's) and of
    ``torch.matmul`` (the
    products' route where autograd records a graph) while installed."""

    NAMES = (("koala_tpu_torch.models.mask_gru", "floor_scan_ref"),
             ("koala_tpu_torch.models.mask_gru", "_gru_recurrent"),
             ("koala_tpu_torch.ops.kernels.floor", "floor_scan_ref"),
             ("koala_tpu_torch.ops.kernels.gru", "gru_stack_ref"),
             ("koala_tpu_torch.ops.kernels.engine_fused", "fused_sequence_ref"),
             ("koala_tpu_torch.ops.kernels.rowmm", "rowmm_ref"),
             ("koala_tpu_torch.ops.kernels.rowmm", "fused_ref"),
             ("koala_tpu_torch.ops.kernels.overlap", "overlap_add_ref"),
             ("koala_tpu_torch.ops.kernels.mmse", "mmse_gain_ref"),
             ("koala_tpu_torch.ops.kernels.lstm", "lstm_cell_ref"),
             ("torch", "matmul"))

    def __enter__(self):
        self.calls, self.orig = 0, []
        for mod_name, name in self.NAMES:
            module = importlib.import_module(mod_name)
            fn = getattr(module, name)
            self.orig.append((module, name, fn))

            def counted(*args, _fn=fn, **kwargs):
                self.calls += 1
                return _fn(*args, **kwargs)
            setattr(module, name, counted)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.orig:
            setattr(module, name, fn)


def load_script(name):
    """A script of scripts/ as a module, to run its functions in this process."""
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(name, os.path.join(here, "scripts",
                                                                     name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def hold_recurrences(path, rec_floor, rec_gru):
    """The floor and GRU kernels against their plain versions on the inputs
    that ``path`` gave them (the first call of each, kept by a ``Recorder`` on
    ``mask_gru``): the floor bit for bit, the GRU within ``GRU_MAX_ABS`` and
    ``GRU_SNR_DB``. Returns the shapes and the GRU's error."""
    from koala_tpu_torch.ops.kernels import floor, gru

    for rec in (rec_floor, rec_gru):
        if rec.args is None:
            fail("%s made no call to mask_gru.%s" % (path, rec.name))
    f0, lb, rise = rec_floor.args
    h0, xg, wx, bx, wh, bh = rec_gru.args
    with torch.inference_mode():
        kf, kfl = floor.floor_scan(f0, lb, rise)
        rf, rfl = floor.floor_scan_ref(f0, lb, rise)
        ky, kh = gru.gru_stack(h0, xg, wx, bx, wh, bh)
        ry, rh = gru.gru_stack_ref(h0, xg, wx, bx, wh, bh)
    torch.cuda.synchronize()
    if not (torch.equal(kf, rf) and torch.equal(kfl, rfl)):
        fail("floor kernel differs from its plain version on %s's inputs, lb %s"
             % (path, list(lb.shape)))
    g_err = max(float((ky.float() - ry.float()).abs().max()), float((kh - rh).abs().max()))
    g_snr = snr_db(ry.float(), ky.float())
    print("%s: floor lb %s bit-identical to its plain version; GRU x %s (%d layers) max|err| "
          "%.4g (%.1f dB) from its plain version" % (path, list(lb.shape), list(xg.shape),
                                                     h0.shape[0], g_err, g_snr))
    if g_snr < GRU_SNR_DB or g_err > GRU_MAX_ABS:
        fail("GRU kernel outside its tolerance on %s's inputs: %.4g, %.1f dB"
             % (path, g_err, g_snr))
    return {"floor_shape": list(lb.shape), "gru_shape": list(xg.shape) + [h0.shape[0]],
            "gru_max_abs_err": g_err, "gru_snr_db": g_snr}


def single_stream_phase(kt, dev, card, reset_counts, counts, pcm):
    """Phase 2b: one stream's ``Koala.enhance`` over the 6.0 s mix on the
    card. The recurrences take a batch of one: the floor and GRU kernels
    launch once each a call, and no plain version runs. Its output against
    the port's on the CPU (>= 35 dB), both kernels against their plain
    versions on the inputs this path gave them, and its time beside that of
    the scan branch (the plain floor scan and the step loop, which the card
    ran for one stream before) on the same input. Returns the launches and
    what the kernels showed on this path."""
    from koala_tpu_torch.engine.core import Engine
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.ops.kernels import floor, gru
    from koala_tpu_torch.profiling import time_ms

    mix = pcm[0, :SINGLE_N]
    k = kt.create(ACCESS_KEY, device="gpu")
    k.enhance(mix[:8 * 256])                 # warm-up (lazy set-up)
    k.reset()
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain, Recorder(mask_gru_model, "floor_scan") as rec_floor, \
            Recorder(mask_gru_model, "gru_stack") as rec_gru:
        s = time.perf_counter()
        out = k.enhance(mix)
        first_ms = (time.perf_counter() - s) * 1e3
    single_counts = counts()
    cpu = kt.create(ACCESS_KEY, device="cpu")
    want = cpu.enhance(mix)
    cpu.delete()
    db = snr_db(want.astype(np.float64), out.astype(np.float64)) if out.shape == want.shape \
        else float("-inf")
    hops = -(-(SINGLE_N + 256) // 256)
    print("path Koala.enhance (one stream): %d samples, %d hops, launches %s, plain-version "
          "calls %d, %.3f ms (first call); card vs CPU %.2f dB"
          % (SINGLE_N, hops, single_counts, plain.calls, first_ms, db))
    if (single_counts["floor_scan"], single_counts["gru_stack"], single_counts["engine_fused"],
            plain.calls) != (1, 1, 0, 0):
        fail("one stream's enhance should launch the floor and GRU kernels once each and "
             "run no plain version: %s, %d plain calls" % (single_counts, plain.calls))
    if out.shape != mix.shape or db < CHUNK_SNR_DB or np.all(out == 0):
        fail("one stream's enhance on the card: shape %s, %.1f dB from the CPU"
             % (out.shape, db))

    def median_ms(reps):
        runs = []
        for _ in range(reps):
            k.reset()
            torch.cuda.synchronize()
            s = time.perf_counter()
            k.enhance(mix)
            runs.append((time.perf_counter() - s) * 1e3)
        return statistics.median(runs), min(runs)

    kernel_ms = median_ms(5)
    kernels_engine = k._engine
    k._engine = Engine(kernels_engine.kind, dict(kernels_engine.config, use_pallas=False))
    scan_ms = median_ms(3)
    k._engine = kernels_engine
    k.delete()
    print("Koala.enhance (one stream, %.1f s): median %.3f ms, least %.3f of 5 further calls "
          "(real-time factor %.5f); the scan branch on the same input median %.3f ms, least "
          "%.3f of 3 on %s" % (SINGLE_N / 16000.0, kernel_ms[0], kernel_ms[1],
                               kernel_ms[0] / 1e3 / (SINGLE_N / 16000.0), scan_ms[0],
                               scan_ms[1], card))

    # both kernels against their plain versions on this path's inputs (B = 1)
    held = hold_recurrences("Koala.enhance (one stream)", rec_floor, rec_gru)
    f0, lb, rise = rec_floor.args
    h0, xg, wx, bx, wh, bh = rec_gru.args
    floor_path = {"launches": single_counts["floor_scan"], "shape": held["floor_shape"],
                  "max_abs_err": 0.0,
                  "queued_ms": time_ms(lambda: floor.floor_scan(f0, lb, rise), 200, 5,
                                       queued=True)}
    gru_path = {"launches": single_counts["gru_stack"], "shape": held["gru_shape"],
                "max_abs_err": held["gru_max_abs_err"], "y_snr_db": held["gru_snr_db"],
                "ms": time_ms(lambda: gru.gru_stack(h0, xg, wx, bx, wh, bh), 10)}
    print("one stream's kernels: floor lb %s queued %.5f ms; GRU x %s %.4f ms on %s"
          % (floor_path["shape"], floor_path["queued_ms"], list(xg.shape), gru_path["ms"], card))
    return single_counts, floor_path, gru_path


def battery_streams(gates):
    """The acceptance sets as streams: the 7 committed held-out pairs (and
    the reference pair and its 8 pseudo-real variants where
    ``KOALA_REFERENCE_SAMPLES`` names them), each set's speech, noise and
    their saturated int16 sum in whole frames. ``gates`` is
    scripts/train_model_torch.py. Returns (sets, streams, batch [n, width]
    int16): streams of other lengths (the resampled variants) end in zeros
    there, as the delayed paths are causal and enhance pads with zeros past
    the end."""
    from koala_tpu_torch.train.evaluate import mix_pcm

    ref = os.environ.get("KOALA_REFERENCE_SAMPLES")
    sets = {name: pair for name, pair in gates.fixture_sets(ref).items()
            if name != "synth_fixture"}
    battery = ["dev_heldout%s:%s" % (row[0], row[3]) for row in gates.DEV_BATTERY]
    if not set(battery) <= set(sets):
        fail("held-out pairs missing: %s" % sorted(set(battery) - set(sets)))
    streams = []
    for speech, noise in sets.values():
        n = len(speech) // 256 * 256
        streams += [speech[:n], noise[:n], mix_pcm(speech, noise)[:n]]
    batch = np.zeros((len(streams), max(len(x) for x in streams)), np.int16)
    for i, x in enumerate(streams):
        batch[i, :len(x)] = x
    return sets, streams, batch


def figures(r):
    """A set's harness results -> (worst parity of the three cases, SI-SDR
    gain, STOI regression)."""
    return (max(r["dev_pure_speech"], r["dev_pure_noise"], r["dev_mixed"]),
            r["si_sdr_gain_db"], r["stoi_input"] - r["stoi_mixed"])


def fused_segments(args):
    """The workspace segments of a fused call made with ``args`` (params,
    state, hops, cfg)."""
    from koala_tpu_torch.ops.kernels import engine_fused

    hops, lay = args[2], engine_fused.Layout(args[3])
    return -(-hops.shape[1] // engine_fused.segment_hops(
        hops.shape[0], engine_fused.frame_bytes(lay.hidden, lay.nbp)))


def acceptance_phase(kt, dev, card, reset_counts, counts):
    """Phase 2c: Koala's acceptance gates (tests/test_parity.py's: the three
    energy cases at 0.02, SI-SDR gain > 3 dB, no STOI regression beyond 0.01,
    with tests/known_gaps.py's ledger and bounds, through
    scripts/train_model_torch.py's ``check_gates``) on four serving paths of
    the card, over every set's three cases (pure speech, pure noise, the
    int16 mix) in whole frames: 21 streams of 365 frames for the battery.
    1. ``KoalaBatch.process_chunk`` at B = 21: the floor and GRU kernels once.
    2. ``KoalaBatch.enhance`` at B = 21: the fused entry (five device launches
       a workspace segment), and the floor and GRU kernels on the tail hops.
    3. ``Koala.enhance`` one stream at a time: the floor and GRU kernels at a
       batch of one, once each a stream.
    4. ``KoalaBatch.process`` frame by frame at B = 21: the eager step, the
       GRU kernel once a frame (at T = 1).
    No path calls a plain version, and every kernel that 1-3 launch is held
    against its plain version on the inputs the path gave it: the floor and
    GRU kernels on 1, 3 and 2's tail, the fused entry on 2. Each set is
    scored by ``harness_results`` (delay 256 on the delayed paths 1 and 4, 0
    on the delay-compensated 2 and 3) beside the CPU port's ``evaluate``. A
    gate that fails beyond its ledgered bound, or a path further from
    ``evaluate`` than ``CPU_DIFF_LIMIT``, fails the run after all four paths
    are printed. Returns the launches of the phase, what the recurrences
    showed on each path and what the fused entry showed."""
    from koala_tpu_torch.constants import DELAY_SAMPLE
    from koala_tpu_torch.engine import core as engine_core
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.ops.kernels import engine_fused
    from koala_tpu_torch.train.evaluate import evaluate, harness_results

    gates = load_script("train_model_torch")
    sets, streams, batch = battery_streams(gates)
    if "reference" not in sets:
        print("acceptance: the reference pair and its 8 pseudo-real variants not run "
              "(KOALA_REFERENCE_SAMPLES names no directory that holds them)")
    names = list(sets)
    lens = [len(x) for x in streams]
    nb, width = batch.shape

    tree, cfg = params_io.load_params(params_io.default_model_path())
    s = time.perf_counter()
    on_cpu = {name: evaluate(tree, cfg, *pair, device="cpu") for name, pair in sets.items()}
    print("acceptance: %d sets, %d streams of up to %d frames; the CPU port's evaluate took "
          "%.2f s" % (len(names), nb, width // 256, time.perf_counter() - s))

    kb = kt.create_batch(ACCESS_KEY, batch_size=nb, device="gpu")
    k = kt.create(ACCESS_KEY, device="gpu")
    kb.process_chunk(batch[:, :8 * 256])     # warm-up (lazy set-up)
    kb.reset()
    kb.enhance(batch[:, :8 * 256])
    kb.reset()
    k.enhance(streams[0][:8 * 256])
    k.reset()
    hops = width // 256 + 1                  # enhance pads one hop
    runs, held = {}, {}

    def run(path, delay, fn, recorders=()):
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.ExitStack() as stack:
            plain = stack.enter_context(PlainCalls())
            recs = [stack.enter_context(Recorder(m, name)) for m, name in recorders]
            s = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - s
        runs[path] = (out, delay, counts(), plain.calls, wall)
        return recs

    recs = run("process_chunk", DELAY_SAMPLE, lambda: kb.process_chunk(batch),
               ((mask_gru_model, "floor_scan"), (mask_gru_model, "gru_stack")))
    held["process_chunk"] = hold_recurrences("acceptance process_chunk", *recs)
    kb.reset()
    rec_fused, *recs = run("enhance", 0, lambda: kb.enhance(batch),
                           ((engine_core, "fused_sequence"), (mask_gru_model, "floor_scan"),
                            (mask_gru_model, "gru_stack")))
    _, _, fused_held = hold_fused("acceptance enhance", rec_fused.args)
    segments = fused_segments(rec_fused.args)
    tail = hops - rec_fused.args[2].shape[1]  # sequence_fast's tail through sequence
    if tail:
        held["enhance"] = hold_recurrences("acceptance enhance (%d-hop tail)" % tail, *recs)

    def one_at_a_time():
        out = np.zeros_like(batch)
        for i, x in enumerate(streams):
            k.reset()
            out[i, :len(x)] = k.enhance(x)
        return out

    recs = run("Koala.enhance", 0, one_at_a_time,
               ((mask_gru_model, "floor_scan"), (mask_gru_model, "gru_stack")))
    held["Koala.enhance"] = hold_recurrences("acceptance Koala.enhance", *recs)
    kb.reset()
    run("process", DELAY_SAMPLE, lambda: np.concatenate(
        [kb.process(batch[:, j:j + 256]) for j in range(0, width, 256)], axis=1))
    kb.delete()
    k.delete()

    want = {"process_chunk": dict(floor_scan=1, gru_stack=1, engine_fused=0),
            "enhance": dict(floor_scan=int(tail > 0), gru_stack=int(tail > 0), engine_fused=1,
                            engine_fused_device=len(engine_fused.STAGES) * segments),
            "Koala.enhance": dict(floor_scan=nb, gru_stack=nb, engine_fused=0),
            "process": dict(floor_scan=0, gru_stack=width // 256, engine_fused=0)}
    cpu_fig = {n: figures(r) for n, r in on_cpu.items()}
    summary, failed = {}, []
    for path, (out, delay, got, plain_calls, wall) in runs.items():
        results = {name: harness_results(*sets[name],
                                         *(out[3 * i + j, :lens[3 * i + j]] for j in range(3)),
                                         delay=delay)
                   for i, name in enumerate(names)}
        fig = {n: figures(r) for n, r in results.items()}
        diff = [max(abs(fig[n][m] - cpu_fig[n][m]) for n in names) for m in range(3)]
        worst = [max(names, key=lambda n: fig[n][0]), min(names, key=lambda n: fig[n][1]),
                 max(names, key=lambda n: fig[n][2])]
        b = 1 if path == "Koala.enhance" else nb
        print("acceptance path %s (B=%d, delay %d): launches %s, plain-version calls %d, "
              "%.3f s; worst parity %.6f (%s), lowest SI-SDR gain %.4f dB (%s), worst STOI "
              "regression %.5f (%s); largest difference from the CPU port's evaluate: parity "
              "%.3g, gain %.3g dB, STOI %.3g (limits %s) on %s"
              % (path, b, delay, got, plain_calls, wall, fig[worst[0]][0], worst[0],
                 fig[worst[1]][1], worst[1], fig[worst[2]][2], worst[2], *diff,
                 "/".join("%g" % v for v in CPU_DIFF_LIMIT[path]), card))
        for n in names:
            print("  %-26s parity %.6f (CPU %.6f)  gain %.4f dB (CPU %.4f)  STOI regression "
                  "%+.5f (CPU %+.5f)" % (n, fig[n][0], cpu_fig[n][0], fig[n][1], cpu_fig[n][1],
                                         fig[n][2], cpu_fig[n][2]))
        ok = gates.check_gates(results, allow_known_gaps=True)
        if not (all(got[key] == v for key, v in want[path].items()) and not got["gru_stack_hs"]
                and got["rowmm"] > 0 and plain_calls == 0):
            failed.append("%s launched %s with %d plain-version calls, expected %s"
                          % (path, got, plain_calls, want[path]))
        if not ok:
            failed.append("%s failed a gate beyond the known-gaps ledger" % path)
        if any(d > lim for d, lim in zip(diff, CPU_DIFF_LIMIT[path])):
            failed.append("%s is further from the CPU port's evaluate than %s: %s"
                          % (path, CPU_DIFF_LIMIT[path], diff))
        summary[path] = {"batch": b, "delay": delay, "launches": got,
                         "plain_calls": plain_calls, "seconds": wall, "gates_pass": ok,
                         "worst_parity": [worst[0], fig[worst[0]][0]],
                         "lowest_gain_db": [worst[1], fig[worst[1]][1]],
                         "worst_stoi_regression": [worst[2], fig[worst[2]][2]],
                         "max_abs_diff_from_cpu": dict(zip(("parity", "gain_db", "stoi"), diff))}
    print(json.dumps({"acceptance": summary, "segments": segments, "card": card}), flush=True)
    if failed:
        fail("acceptance: " + "; ".join(failed))
    launches = {key: sum(runs[p][2][key] for p in runs)
                for key in ("floor_scan", "gru_stack", "gru_stack_hs", "engine_fused", "rowmm")}
    return launches, held, fused_held


def generators_phase(card):
    """Phase 11: the port's data generators on this machine, which has no
    JAX: scripts/make_corpus_torch.py (``--speech-utts 2 --noise-clips 2``:
    small tapes, the whole dev battery) and scripts/make_fixtures_torch.py
    into a temporary directory, twice. The two runs must write the same
    bytes, and every WAV 93680 samples (5.855 s). How many of the WAVs equal
    the committed ones is printed, not gated: the synthesiser has changed
    since they were written."""
    from koala_tpu_torch.io import read_wav

    corpus_gen = load_script("make_corpus_torch")
    fixtures_gen = load_script("make_fixtures_torch")
    committed = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources",
                             "audio_samples")
    trees, secs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(2):
            root = os.path.join(tmp, "run%d" % i)
            corpus_gen.CORPUS_DIR = os.path.join(root, "corpus")
            corpus_gen.SAMPLES_DIR = fixtures_gen.OUT_DIR = os.path.join(root, "audio_samples")
            s = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                corpus_gen.main(["--speech-utts", "2", "--noise-clips", "2"])
                fixtures_gen.main()
            secs.append(time.perf_counter() - s)
            tree = {}
            for sub in ("corpus", "audio_samples"):
                for name in sorted(os.listdir(os.path.join(root, sub))):
                    with open(os.path.join(root, sub, name), "rb") as fh:
                        tree[os.path.join(sub, name)] = fh.read()
            trees.append(tree)
        wavs = [n for n in trees[0] if n.endswith(".wav")]
        lengths = {n: len(read_wav(os.path.join(tmp, "run0", n))) for n in wavs}
    same_as_committed = 0
    for n in wavs:
        path = os.path.join(committed, os.path.basename(n))
        if os.path.exists(path):
            with open(path, "rb") as fh:
                same_as_committed += fh.read() == trees[0][n]
    print("generators: make_corpus_torch.py --speech-utts 2 --noise-clips 2 and "
          "make_fixtures_torch.py wrote %d files (%d tapes, %d WAVs), the two runs %s, in %.2f "
          "and %.2f s; WAV lengths %s; %d of the %d WAVs equal the committed files"
          % (len(trees[0]), len(trees[0]) - len(wavs), len(wavs),
             "byte-identical" if trees[0] == trees[1] else "DIFFERENT", secs[0], secs[1],
             sorted(set(lengths.values())), same_as_committed, len(wavs)))
    if trees[0] != trees[1] or len(trees[0]) != 19:
        fail("generators: %d files, two runs byte-identical: %s"
             % (len(trees[0]), trees[0] == trees[1]))
    if set(lengths.values()) != {93680}:
        fail("generators: WAV sample counts %s, not 93680" % lengths)
    return secs


def bench_sweep_phase(dev, card, reset_counts, counts):
    """Phase 8b: ``scripts/bench_sweep_torch.py``'s sections 1 and 1b in
    this process at B = 512 x 376, a few timed calls each. Prints the record
    on a line of its own. The floor and GRU kernels are held against their
    plain versions on the inputs that its unfused ``sequence`` gave them.
    Returns the launches and what the check showed."""
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.ops.kernels import engine_fused

    sweep = load_script("bench_sweep_torch")
    engine, params = sweep.load_engine(dev)
    torch.cuda.synchronize()
    reset_counts()
    record = dict(sweep.card_keys(dev), batch=BENCH_B, frames=T, iters=SWEEP_ITERS)
    with Recorder(mask_gru_model, "floor_scan") as rec_floor, \
            Recorder(mask_gru_model, "gru_stack") as rec_gru:
        record.update(sweep.component_split(engine, params, dev, BENCH_B, T, SWEEP_ITERS))
    record["components"] = sweep.components(engine, params, dev, BENCH_B, T, SWEEP_ITERS)
    torch.cuda.synchronize()
    sweep_counts = counts()
    print(json.dumps({"bench_sweep": record}), flush=True)
    print("path bench_sweep_torch sections 1 and 1b: B=%d x T=%d, sequence %.3f ms, "
          "sequence_fast %.3f ms (%d segments; stages %s), GRU kernel %.4f ms (%.4f of its "
          "bound), launches %s on %s"
          % (BENCH_B, T, record["sequence_ms"], record["full_sequence_ms"],
             record["fused_segments"], record["fused_stage_ms"], record["kernel_ms"],
             record["kernel_roofline"]["tensor_fraction"], sweep_counts, card))
    if min(sweep_counts["floor_scan"], sweep_counts["gru_stack"],
           sweep_counts["engine_fused"]) < 1:
        fail("bench_sweep did not launch the floor, GRU and fused kernels: %s" % sweep_counts)
    if record["fused_segments"] * len(engine_fused.STAGES) != BENCH_FUSED_LAUNCHES \
            or not all(np.isfinite(v) for v in record["fused_stage_ms"].values()):
        fail("bench_sweep's fused entry: %d segments, stages %s"
             % (record["fused_segments"], record["fused_stage_ms"]))
    return sweep_counts, hold_recurrences("bench_sweep sequence", rec_floor, rec_gru)


def pod_wash_phase(card, reset_counts, counts):
    """Phase 8c: ``scripts/pod_wash_torch.py`` on the card's one-device mesh
    (4 batches of 64 utterances of 6.0 s, one of them the warm-up). Its
    records are printed as lines of their own. Each batch runs its whole
    segments through the fused entry and the hops after them through the
    floor and GRU kernels, which are held against their plain versions on
    the inputs of the first such tail. Returns the launches and what the
    check showed."""
    from koala_tpu_torch.models import mask_gru as mask_gru_model

    wash = load_script("pod_wash_torch")
    torch.cuda.synchronize()
    reset_counts()
    with Recorder(mask_gru_model, "floor_scan") as rec_floor, \
            Recorder(mask_gru_model, "gru_stack") as rec_gru:
        records = wash.main(POD_WASH_ARGS)
    torch.cuda.synchronize()
    wash_counts = counts()
    report = records[0]
    print("path pod_wash_torch: mesh of %d card, %d batches counted, %.1f audio-s/s, "
          "launches %s on %s" % (report["chips"], report["batches"],
                                 report["audio_seconds_per_second"], wash_counts, card))
    if report["chips"] != 1 or report["batches"] != 3 or wash_counts["engine_fused"] != 4 \
            or not report["audio_seconds_per_second"] > 0:
        fail("pod_wash on the card: %s, launches %s" % (report, wash_counts))
    return wash_counts, hold_recurrences("pod_wash tail", rec_floor, rec_gru)


def serving_phases(dev, card, reset_counts, counts, pcm, out_chunk, out_cpu):
    """Phase 6: the StreamingServer on the card (backlog rounds, live cadence
    with a reset), and one round trip through scripts/serve_tcp_torch.py.
    Returns the launches of the backlog run, and what the floor and GRU
    kernels showed against their plain versions on its first round's inputs."""
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.serve import StreamingServer

    rows = np.ascontiguousarray(pcm[:, :T * 256].reshape(B, T, 256))

    def server(**kw):
        return StreamingServer(ACCESS_KEY, num_streams=B, device="gpu", capacity_frames=T,
                               chunk_frames=SERVE_CHUNK, **kw)

    # warm-up: one full chunk of every stream through a server of its own
    warm = server()
    warm.push_block(rows[:, :SERVE_CHUNK], np.full(B, SERVE_CHUNK, np.int32))
    pull_all(warm, B, SERVE_CHUNK)
    warm.close()

    # ---- backlog: every stream's 6.0 s in one push, every round a full chunk
    srv = server()
    torch.cuda.synchronize()
    reset_counts()
    with Recorder(mask_gru_model, "floor_scan") as rec_floor, \
            Recorder(mask_gru_model, "gru_stack") as rec_gru:
        s = time.perf_counter()
        accepted = srv.push_block(rows, np.full(B, T, np.int32))
        got = pull_all(srv, B, T)
        wall = time.perf_counter() - s
    backlog_counts = counts()
    stats = srv.stats
    srv.close()
    if accepted != B * T:
        fail("push_block accepted %d of %d frames" % (accepted, B * T))
    if backlog_counts["floor_scan"] < 1 or backlog_counts["gru_stack"] < 1:
        fail("the server's backlog rounds did not launch the floor and GRU kernels: %s"
             % backlog_counts)
    served = got.reshape(B, T * 256)
    d_chunk = int(np.abs(served.astype(np.int32) - out_chunk).max())
    snr_chunk = min(snr_db(out_chunk[i].astype(np.float64), served[i].astype(np.float64))
                    for i in range(B))
    snr_cpu = [snr_db(out_cpu[i].astype(np.float64), served[i].astype(np.float64))
               for i in range(2)]
    print("path StreamingServer backlog: B=%d streams x T=%d frames, chunk %d: %.0f frames/s, "
          "%.1f audio-s/s, %.3f s wall, device steps %d, dropped samples %d / %d, launches %s "
          "on %s" % (B, T, SERVE_CHUNK, B * T / wall, B * T * 256 / 16000.0 / wall, wall,
                     stats["device_steps"], stats["dropped_samples"],
                     stats["dropped_output_samples"], backlog_counts, card))
    print("server backlog vs KoalaBatch.process_chunk on the card: max |diff| %d LSB, least "
          "%.2f dB; vs the port on the CPU (2 streams): %s dB"
          % (d_chunk, snr_chunk, ["%.2f" % v for v in snr_cpu]))
    if min(snr_cpu) < CHUNK_SNR_DB:
        fail("the server on the card is %.1f dB from the port on the CPU" % min(snr_cpu))
    if stats["dropped_samples"] or stats["dropped_output_samples"]:
        fail("the backlog run dropped samples: %s" % stats)

    # ---- live cadence: every stream one frame every 16 ms, one stream reset
    live_frames = int(LIVE_S * 1000 / 16)
    rs = 5                                      # the stream that is reset
    lat_ms, _, stale, after_reset, stats = live_cadence(server(), rows, live_frames,
                                                        reset_stream=rs)
    p50, p90 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 90)
    print("path StreamingServer live: %d streams, one frame each every 16 ms for %.1f s: "
          "push-to-pull latency per frame p50 %.3f ms, p90 %.3f ms, max %.3f ms over %d frames; "
          "device steps %d; dropped samples %d / %d on %s"
          % (B, LIVE_S, p50, p90, lat_ms.max(), len(lat_ms), stats["device_steps"],
             stats["dropped_samples"], stats["dropped_output_samples"], card))
    print("reset of stream %d mid-run: %d frames after it, %d nonzero samples (pre-reset audio)"
          % (rs, after_reset, stale))
    if p50 >= 16.0:
        fail("live cadence: p50 latency %.2f ms is not below one 16 ms frame" % p50)
    if stale or after_reset == 0:
        fail("after reset(): %d nonzero samples in %d frames" % (stale, after_reset))

    # ---- one TCP round trip through the port's front, 128 frames of stream 0
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    n = TCP_FRAMES * 256
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "scripts", "serve_tcp_torch.py"), "--device", "gpu",
         "--port", str(port), "--streams", str(B), "--chunk_frames", str(SERVE_CHUNK)],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        import socket

        wait_for_port(proc, port, "serve_tcp_torch.py")
        s = time.perf_counter()
        conn = socket.create_connection(("127.0.0.1", port), timeout=120)
        conn.sendall(pcm[0, :n].astype("<i2").tobytes())
        conn.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            data = conn.recv(65536)
            if not data:
                break
            chunks.append(data)
        conn.close()
        tcp_s = time.perf_counter() - s
        client = c_client_round_trip(here, port, pcm[0, :n])
    finally:
        stop(proc)
    reply = np.frombuffer(b"".join(chunks), dtype="<i2")
    if reply.shape != (n,):
        fail("TCP reply has %s samples for %d sent" % (reply.shape, n))
    # the reply is delay-compensated: reply[i] is the served stream's sample
    # 256 + i; its last 256 samples come from the flush frames
    d_tcp = int(np.abs(reply[:n - 256].astype(np.int32) - served[0, 256:n]).max())
    print("TCP round trip (scripts/serve_tcp_torch.py --device gpu): %d samples in %.3f s, "
          "aligned 1:1, max |diff| against the backlog run %d LSB on %s"
          % (n, tcp_s, d_tcp, card))
    if d_tcp > 2:
        fail("the TCP reply is %d LSB from the backlog run" % d_tcp)
    c_reply, c_stdout = client
    d_c = int(np.abs(c_reply[:n - 256].astype(np.int32) - served[0, 256:n]).max()) \
        if c_reply.shape == (n,) else -1
    rtf = re.search(r"Real time factor: (\S+)", c_stdout)
    print("C client demo (demo/c/koala_client_demo.c, gcc -O2) through scripts/serve_tcp_torch.py "
          "--device gpu: %d samples for %d, real time factor %s, max |diff| against the backlog "
          "run %d LSB on %s" % (len(c_reply), n, rtf.group(1) if rtf else "missing", d_c, card))
    if c_reply.shape != (n,) or rtf is None or not 0 <= d_c <= 2:
        fail("the C client's reply: %d samples for %d, %d LSB from the backlog run"
             % (len(c_reply), n, d_c))
    return backlog_counts, hold_recurrences("server backlog", rec_floor, rec_gru)


def wait_for_port(proc, port, name, timeout_s=120):
    """Waits until ``proc`` (a front started as a subprocess) accepts
    connections on ``port``; fails if it exits or the time runs out."""
    import socket

    deadline = time.time() + timeout_s
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            if proc.poll() is not None or time.time() > deadline:
                fail("%s did not start: %s" % (name, proc.stdout.read() if proc.poll() is not None
                                               else "timeout"))
            time.sleep(0.2)


def stop(proc):
    """Ends a subprocess: terminate, then kill if it lingers."""
    proc.terminate()
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=20)


def live_cadence(srv, rows, live_frames, reset_stream=None):
    """Live rounds on ``srv``: four single-frame rounds of rows[:, :4] first,
    then every stream one frame of rows[:, 4:] every 16 ms for
    ``live_frames`` frames, pulled as they come back. ``reset_stream`` is
    reset before the live frames and again half-way, and sends silence after
    the second reset. Returns (push-to-pull latency of every frame in ms,
    the live frames that came back [n, live_frames, 256] (the reset stream's
    left zero), the reset stream's nonzero samples after its reset, its
    frames after the reset, the server's stats); closes the server."""
    n = rows.shape[0]
    rs = reset_stream
    warm_rows = rows[:, :4].copy()
    for j in range(4):                          # a few single-frame rounds first
        srv.push_block(warm_rows[:, j:j + 1], np.ones(n, np.int32))
        time.sleep(0.016)
    pull_all(srv, n, 4)
    if rs is not None:
        srv.reset(rs)
        time.sleep(0.05)
        srv.pull(rs)
    push_at = np.zeros(live_frames)
    reset_at = live_frames // 2
    reset_done = threading.Event()
    live = rows[:, 4:4 + live_frames].copy()
    if rs is not None:
        live[rs, reset_at:] = 0                 # after the reset, stream rs sends silence

    def producer():
        t0 = time.perf_counter()
        for j in range(live_frames):
            wait = t0 + j * 0.016 - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if rs is not None and j == reset_at:
                srv.reset(rs)
                reset_done.set()
            push_at[j] = time.perf_counter()
            srv.push_block(live[:, j:j + 1], np.ones(n, np.int32))

    th = threading.Thread(target=producer, daemon=True)
    lat, have = [], np.zeros(n, np.int64)
    got = np.zeros((n, live_frames, 256), np.int16)
    others = [i for i in range(n) if i != rs]
    stale = after_reset = 0
    th.start()
    deadline = time.time() + live_frames * 0.016 + 30
    while time.time() < deadline:
        reset_seen = reset_done.is_set()
        out_rows, cnt = srv.pull_block(8)
        now = time.perf_counter()
        for i in np.nonzero(cnt)[0]:
            c = int(cnt[i])
            if i == rs:
                if reset_seen:
                    after_reset += c
                    stale += int(np.count_nonzero(out_rows[i, :c]))
                continue
            lat.append(now - push_at[have[i]:have[i] + c])
            got[i, have[i]:have[i] + c] = out_rows[i, :c]
            have[i] += c
        if not th.is_alive() and have[others].min() >= live_frames:
            break
        if not cnt.any():
            time.sleep(0.0002)
    th.join(timeout=10)
    stats = srv.stats
    srv.close()
    if have[others].min() < live_frames:
        fail("live cadence: %d of %d frames came back" % (have[others].sum(),
                                                         len(others) * live_frames))
    return np.concatenate(lat) * 1e3, got, stale, after_reset, stats


def c_client_round_trip(here, port, pcm):
    """Builds demo/c/koala_client_demo.c with gcc into a temporary directory
    and streams ``pcm`` through it to the TCP front on ``port``. Returns the
    WAV it wrote and its standard output; fails unless it exits 0 with
    nothing on stderr."""
    from koala_tpu_torch.io import read_wav, write_wav

    with tempfile.TemporaryDirectory() as tmp:
        client = os.path.join(tmp, "koala_client_demo")
        build = subprocess.run(["gcc", "-O2", "-Wall", "-Wextra", "-o", client,
                                os.path.join(here, "demo", "c", "koala_client_demo.c")],
                               capture_output=True, text=True, timeout=120)
        if build.returncode != 0:
            fail("gcc koala_client_demo.c: " + build.stderr[-2000:])
        write_wav(os.path.join(tmp, "in.wav"), pcm)
        r = subprocess.run([client, os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.wav"),
                            "127.0.0.1", str(port)], capture_output=True, text=True, timeout=120)
        if r.returncode != 0 or r.stderr:
            fail("koala_client_demo: exit %d, stderr %r" % (r.returncode, r.stderr[-2000:]))
        return read_wav(os.path.join(tmp, "out.wav")), r.stdout


def parallel_phases(dev, card, reset_counts, counts, pcm):
    """Phase 7: CorpusRunner on a mesh of one card, and the data-parallel
    train step under a one-rank NCCL group against the unsharded step.
    Returns the launches of both runs."""
    import torch.distributed as dist

    from koala_tpu_torch.engine.stream import load_model
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.models.params_io import default_model_path
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh
    from koala_tpu_torch.train import corpus
    from koala_tpu_torch.train.device_sampler import sample_from_tapes

    trainer = importlib.import_module("koala_tpu_torch.train.train")

    # ---- CorpusRunner: B = 64 utterances of 6.0 s on one card
    mesh = make_mesh(["gpu:0"])
    samples = T * 256
    corpus_pcm = pcm[:, :samples].astype(np.float32) / 32768.0
    runner = CorpusRunner(default_model_path(), global_batch=B, utterance_samples=samples,
                          mesh=mesh)
    runner.enhance_batch(corpus_pcm)                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = runner.enhance_batch(corpus_pcm)
    torch.cuda.synchronize()
    corpus_counts = counts()
    engine, params = load_model(default_model_path(), dev)
    with torch.inference_mode():
        hops = torch.as_tensor(corpus_pcm.reshape(B, T, 256), device=dev)
        _, ref = engine.sequence_fast(params, engine.init_state((B,), dev), hops)
    torch.cuda.synchronize()
    if corpus_counts["engine_fused"] < 1:
        fail("CorpusRunner did not launch the fused engine: %s" % corpus_counts)
    if not torch.equal(out, ref):
        fail("CorpusRunner differs from Engine.sequence_fast (max |err| %g)"
             % float((out - ref).abs().max()))
    report = runner.wash([corpus_pcm] * 6, warmup=1)
    print("path CorpusRunner: mesh of 1 card, B=%d x %.1f s, launches %s, bit-identical to "
          "Engine.sequence_fast; wash of 5 batches: %.1f audio-s/s (%.4f s wall) on %s"
          % (B, samples / 16000.0, corpus_counts, report["audio_seconds_per_second"],
             report["wall_seconds"], card))

    # ---- data-parallel step, one rank of an NCCL group, against the unsharded step
    cfg = dict(mask_gru_model.TRAIN_CONFIG)
    speech = torch.as_tensor(corpus.build_speech_tape(101, 4), device=dev)
    noise = torch.as_tensor(corpus.build_noise_tape(202, 4), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    noisy, clean = sample_from_tapes(speech, noise, gen, TRAIN_B, TRAIN_T * 256)
    init = mask_gru_model.init_params(gen, cfg)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d" % free_port(),
                            rank=0, world_size=1)
    try:
        dp_mesh = make_mesh(["gpu:0"])
        if dp_mesh.group is None or dp_mesh.world != 1:
            fail("the mesh did not take the NCCL group: %r" % dp_mesh)
        results = {}
        for name, m in (("unsharded", None), ("data-parallel", dp_mesh)):
            p = copy.deepcopy(init).requires_grad_(True)
            step = trainer.make_train_step(cfg, trainer.make_optimizer(p, 3e-4, 200), mesh=m)
            torch.cuda.synchronize()
            reset_counts()
            loss = step(p, noisy, clean)
            torch.cuda.synchronize()
            results[name] = (loss, p, counts())
        (l0, p0, _), (l1, p1, dp_counts) = results["unsharded"], results["data-parallel"]
        same = torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in
                                           zip(p0.parameters(), p1.parameters()))
        if not same:
            fail("the one-rank data-parallel step differs from the unsharded step: loss %r "
                 "vs %r" % (float(l1), float(l0)))
        step = trainer.make_train_step(cfg, trainer.make_optimizer(p1, 3e-4, 200), mesh=dp_mesh)
        ms = []
        for i in range(8):
            torch.cuda.synchronize()
            s = time.perf_counter()
            step(p1, noisy, clean)
            torch.cuda.synchronize()
            if i >= 2:
                ms.append((time.perf_counter() - s) * 1e3)
    finally:
        dist.destroy_process_group()
    if dp_counts["gru_stack_hs"] != 1 or dp_counts["floor_scan"] != 1:
        fail("a data-parallel step must launch gru_stack_hs and floor_scan once: %s" % dp_counts)
    print("path data-parallel train step: one NCCL rank, TRAIN_CONFIG B=%d x T=%d, loss %.6f "
          "and weights bit-identical to the unsharded step; %.2f ms a step (median of %d, "
          "%.2f-%.2f); launches %s on %s"
          % (TRAIN_B, TRAIN_T, float(l1), statistics.median(ms), len(ms), min(ms), max(ms),
             dp_counts, card))
    return corpus_counts, dp_counts


def bench_phase(dev, card, reset_counts, counts):
    """Phase 8: bench_torch.py's phases in this process at the full batch.
    Prints bench.py's record on a line of its own; returns the launches, the
    fused entry's time and bound at the bench's shape, and what the floor and
    GRU kernels showed against their plain versions on the inputs of their
    first call (a serving round)."""
    import bench_torch
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.ops.kernels import engine_fused
    from koala_tpu_torch.profiling import time_ms

    torch.cuda.synchronize()
    reset_counts()
    with Recorder(mask_gru_model, "floor_scan") as rec_floor, \
            Recorder(mask_gru_model, "gru_stack") as rec_gru:
        record = bench_torch.run(dev, batch=BENCH_B, frames=T, iters=BENCH_ITERS,
                                 **BENCH_SERVE)
    torch.cuda.synchronize()
    bench_counts = counts()
    print(json.dumps(record), flush=True)
    calls = BENCH_ITERS + 1                          # the warm-up call and the timed ones
    per_call = bench_counts["engine_fused_device"] / max(bench_counts["engine_fused"], 1)
    print("path bench_torch: B=%d x T=%d, %d fused calls, %g device launches a call (%d "
          "segments), %.1f audio-s/s; serving %.1f audio-s/s at %d streams; step device "
          "%.4f ms; launches %s on %s"
          % (BENCH_B, T, bench_counts["engine_fused"], per_call, record["segments"],
             record["value"], record["serving_audio_s_per_s_per_chip"],
             record["serving_streams"], record["step_device_p50_ms"], bench_counts, card))
    if bench_counts["engine_fused"] != calls or per_call != BENCH_FUSED_LAUNCHES \
            or record["segments"] * len(engine_fused.STAGES) != BENCH_FUSED_LAUNCHES:
        fail("the bench's engine calls should each make %d device launches: %s"
             % (BENCH_FUSED_LAUNCHES, bench_counts))
    if bench_counts["floor_scan"] < 1 or bench_counts["gru_stack"] < 1:
        fail("the bench's serving rounds did not launch the floor and GRU kernels: %s"
             % bench_counts)
    if record["device"] != torch.cuda.get_device_name(0) or not record["power_limit_w"]:
        fail("the bench record names no card: %s, %s" % (record["device"],
                                                         record["power_limit_w"]))

    # the fused entry alone at the bench's shape, on the card's clock
    engine, params = bench_torch.load_engine(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    hops = 0.1 * torch.randn((BENCH_B, T, 256), generator=gen, device=dev)
    state = engine.init_state((BENCH_B,), dev)
    with torch.inference_mode():
        ms = time_ms(lambda: engine_fused.fused_sequence(params, state, hops, engine.config), 5)
    bound = engine_fused.bound(params, engine.config, BENCH_B, T)
    at_bench = {"bench_shape": [BENCH_B, T, 256], "bench_ms": ms,
                "bench_bound_ms": max(bound.values()), "bench_bound_by": max(bound, key=bound.get),
                "bench_device_launches_per_call": per_call}
    print("fused at the bench's shape [%d, %d, 256]: %.4f ms a call, bound_ms %.4f (%s), %g "
          "device launches a call on %s" % (BENCH_B, T, ms, at_bench["bench_bound_ms"],
                                            at_bench["bench_bound_by"], per_call, card))
    return bench_counts, at_bench, hold_recurrences("bench", rec_floor, rec_gru)


class WarningCount(logging.Handler):
    """Counts the port's warnings that the GRU kernel is not taken."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.n = 0

    def emit(self, record):
        if "GRU kernel DISABLED" in record.getMessage():
            self.n += 1


def gate_phase(kt, dev, card, reset_counts, counts):
    """Phase 9: seeded ``init_params`` models at three widths and depths,
    each through ``process_chunk`` and ``enhance`` at B = 64 x 64 hops: 384 x
    2 and 512 x 3 have a launch plan (one and two layer groups) and launch
    the GRU kernel and the fused entry; 768 x 3 has none (nor does
    koala_tpu's kernel take it) and runs the scan branch with one warning.
    512 x 3 and 768 x 3 also take one ``train_on_device`` step at B = 8,
    through the kernel's ``return_hidden`` variant and through the scan.
    Returns the launches of every kernel."""
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.train import corpus

    trainer = importlib.import_module("koala_tpu_torch.train.train")
    pcm = mix_streams(GATE_T * 256)
    launched = {"floor_scan": 0, "gru_stack": 0, "gru_stack_hs": 0, "engine_fused": 0,
                "rowmm": 0}
    watch = WarningCount()
    logging.getLogger("koala_tpu_torch").addHandler(watch)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for hidden, layers, fits, train in GATE_MODELS:
                cfg = dict(mask_gru_model.TRAIN_CONFIG, hidden=hidden, num_layers=layers)
                if mask_gru_model.gru_kernel_fits(GATE_B, hidden, layers, sms) is not fits:
                    fail("gate: a launch plan for hidden %d x %d is %s, not %s"
                         % (hidden, layers, not fits, fits))
                path = os.path.join(tmp, "h%d_l%d.pv" % (hidden, layers))
                params_io.save_params(
                    path, mask_gru_model.init_params(torch.Generator().manual_seed(5), cfg),
                    cfg)
                kb = kt.create_batch(ACCESS_KEY, batch_size=GATE_B, model_path=path,
                                     device="gpu")
                torch.cuda.synchronize()
                reset_counts()
                out = kb.process_chunk(pcm)
                chunk_counts = counts()
                kb.reset()
                reset_counts()
                enh = kb.enhance(pcm)
                enh_counts = counts()
                kb.delete()
                cpu = kt.create_batch(ACCESS_KEY, batch_size=4, model_path=path, device="cpu")
                snr = [snr_db(c.astype(np.float64), o.astype(np.float64))
                       for c, o in zip(cpu.process_chunk(pcm[:4]), out[:4])]
                cpu.delete()
                print("gate: hidden %d x %d layers (launch plan: %s), B=%d x T=%d: "
                      "process_chunk launches %s, enhance launches %s; card vs CPU %s dB"
                      % (hidden, layers, fits, GATE_B, GATE_T, chunk_counts, enh_counts,
                         ["%.2f" % v for v in snr]))
                if out.shape != pcm.shape or enh.shape != pcm.shape or min(snr) < CHUNK_SNR_DB:
                    fail("gate: hidden %d x %d on the card: shapes %s %s, %.1f dB from the CPU"
                         % (hidden, layers, out.shape, enh.shape, min(snr)))
                if chunk_counts["floor_scan"] != 1 or chunk_counts["gru_stack"] != int(fits):
                    fail("gate: process_chunk at hidden %d x %d launched %s"
                         % (hidden, layers, chunk_counts))
                # with a plan, enhance takes the fused entry over 64 hops (its stages
                # are its own) and ``sequence`` over the padded 65th: the floor and
                # GRU kernels; without, the floor kernel and the scan over all 65
                if (enh_counts["engine_fused"], enh_counts["gru_stack"],
                        enh_counts["floor_scan"]) != ((1, 1, 1) if fits else (0, 0, 1)):
                    fail("gate: enhance at hidden %d x %d launched %s"
                         % (hidden, layers, enh_counts))
                for k in launched:
                    launched[k] += chunk_counts[k] + enh_counts[k]
                if not train:
                    continue
                speech = corpus.build_speech_tape(101, 2)
                noise = corpus.build_noise_tape(202, 2)
                log = io.StringIO()
                reset_counts()
                with contextlib.redirect_stdout(log):
                    trained, _ = trainer.train_on_device(
                        speech, noise, steps=1, batch=8, segment_frames=TRAIN_T, config=cfg,
                        log_every=1, seed=3, device="gpu")
                torch.cuda.synchronize()
                train_counts = counts()
                losses = [float(v) for v in re.findall(r"loss (\S+)", log.getvalue())]
                print("gate: one train_on_device step at hidden %d x %d, B=8 x T=%d: loss %s, "
                      "launches %s" % (hidden, layers, TRAIN_T, losses, train_counts))
                if len(losses) != 1 or not np.isfinite(losses[0]) \
                        or train_counts["gru_stack_hs"] != int(fits) or not all(
                            torch.isfinite(p).all() for p in trained.parameters()):
                    fail("gate: the train step at hidden %d x %d: losses %s, launches %s"
                         % (hidden, layers, losses, train_counts))
                for k in launched:
                    launched[k] += train_counts[k]
    finally:
        logging.getLogger("koala_tpu_torch").removeHandler(watch)
    print("gate: %d warning(s) that the GRU kernel is not taken" % watch.n)
    if watch.n != 1:
        fail("gate: %d warnings that the GRU kernel is not taken, not one" % watch.n)
    return launched


def demo_phase(card):
    """Phase 10: the port's file demo on the card, as a user runs it, against
    the same demo on the CPU (in this process)."""
    from koala_tpu_torch.io import read_wav, write_wav

    here = os.path.dirname(os.path.abspath(__file__))
    audio = os.path.join(here, "resources", "audio_samples")
    demo = os.path.join(here, "demo", "koala_demo_file_torch.py")
    speech = read_wav(os.path.join(audio, "speech_dev.wav")).astype(np.int32)
    noise = read_wav(os.path.join(audio, "noise_dev.wav")).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        mix = os.path.join(tmp, "mix.wav")
        write_wav(mix, np.clip(speech + noise, -32768, 32767).astype(np.int16))
        r = subprocess.run([sys.executable, demo, "--device", "gpu", "--input_path", mix,
                            "--output_path", os.path.join(tmp, "gpu.wav")],
                           cwd=here, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            fail("koala_demo_file_torch.py --device gpu: %s" % (r.stdout + r.stderr)[-2000:])
        spec = importlib.util.spec_from_file_location("koala_demo_file_torch", demo)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        with contextlib.redirect_stdout(io.StringIO()):
            module.main(["--device", "cpu", "--input_path", mix,
                         "--output_path", os.path.join(tmp, "cpu.wav")])
        gpu, cpu = (read_wav(os.path.join(tmp, n)) for n in ("gpu.wav", "cpu.wav"))
    rtf = re.search(r"Real time factor: (\S+)", r.stdout)
    db = snr_db(cpu.astype(np.float64), gpu.astype(np.float64)) if gpu.shape == cpu.shape \
        else float("-inf")
    print("demo koala_demo_file_torch.py --device gpu: %.3f s of audio, real time factor %s, "
          "%.2f dB from --device cpu on %s"
          % (len(gpu) / 16000.0, rtf.group(1) if rtf else "missing", db, card))
    if rtf is None or gpu.shape != speech.shape or db < CHUNK_SNR_DB:
        fail("the file demo on the card: %d samples for %d, %.1f dB from the CPU"
             % (len(gpu), len(speech), db))


def device_launches(fn):
    """The device's launches (kernels, copies and sets) during one call of
    ``fn``, and how many of them are the port's kernels, from a profiler
    trace (scripts/bench_sweep_torch.py's grouping)."""
    from koala_tpu_torch import profiling

    sweep = load_script("bench_sweep_torch")
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            fn()
            torch.cuda.synchronize()
        groups = sweep.census_of_trace(os.path.join(tmp, profiling.TRACE_FILE))
    return sum(g["count"] for g in groups.values()), groups["port"]["count"]


def card_vs_cpu(got, want):
    """int16 outputs [n, samples] of the card and the CPU: (dB over all of
    them, the least dB of a stream, max |diff| in LSB, share of samples more
    than 2 LSB apart)."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    if got.shape != want.shape:
        return float("-inf"), float("-inf"), -1, 1.0
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return (snr_db(want.astype(np.float64), got.astype(np.float64)),
            min(snr_db(w.astype(np.float64), g.astype(np.float64)) for g, w in zip(got, want)),
            int(diff.max()), float(np.count_nonzero(diff > 2) / diff.size))


def only_rowmm(launched) -> bool:
    """Whether the only counted kernel in ``launched`` was the fixed-order
    product, which did launch."""
    return launched["rowmm"] > 0 and not any(v for k, v in launched.items() if k != "rowmm")


def only_mmse_kernels(launched, sequences) -> bool:
    """Whether the counted kernels in ``launched`` were the fixed-order
    product, which did launch, and the mmse gain kernel, once for each of
    ``sequences`` sequence calls."""
    return (launched["rowmm"] > 0 and launched["mmse_gain"] == sequences
            and not any(v for k, v in launched.items() if k not in ("rowmm", "mmse_gain")))


def surface_mmse(kt, card, reset_counts, counts, pcm, bat, path):
    """Part 1 of the surface phase: the mmse model (its STFT products through
    ``rowmm``, its gain recurrence through its own kernel, one launch a
    sequence call) through every entry point on the card. Each path's output
    is held to the port on the CPU on the same input (>= CHUNK_SNR_DB over
    all its streams); its census is one traced call (device launches, of the
    port's kernels only ``rowmm``'s and the gain kernel's) and its counters
    and plain-version calls are read over its timed calls (only ``rowmm``
    and the gain kernel, once a sequence call; no plain call, the step's
    plain chain aside); the timed calls follow one to warm up
    (``SURFACE_REPS`` of them, the per-frame paths one pass of a stream).
    The battery paths are scored by the harness beside the CPU port's
    ``evaluate`` for the record. Returns (failures, summary)."""
    from koala_tpu_torch.constants import DELAY_SAMPLE
    from koala_tpu_torch.models import mmse as mmse_model
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel
    from koala_tpu_torch.ops.kernels import rowmm
    from koala_tpu_torch.serve import StreamingServer
    from koala_tpu_torch.train.evaluate import evaluate, harness_results

    sets, streams, battery = bat

    def traced(fn):
        """device_launches of ``fn``, and the launches of rowmm and of the
        gain kernel in it."""
        before = rowmm.launches + mmse_kernel.launches
        total, port = device_launches(fn)
        return total, port, rowmm.launches + mmse_kernel.launches - before
    names, lens = list(sets), [len(x) for x in streams]
    mix = pcm[:, :T * 256]
    failures, summary, scored = [], {}, {}

    def single(device):
        return kt.create(ACCESS_KEY, model_path=path, device=device)

    def pool(b):
        return lambda device: kt.create_batch(ACCESS_KEY, batch_size=b, model_path=path,
                                              device=device)

    lat = []

    def frames_one(k):
        del lat[:]
        out = []
        for s in range(0, mix.shape[1], 256):
            t0 = time.perf_counter()
            out.append(k.process(mix[0, s:s + 256].tolist()))
            lat.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(out, np.int16).reshape(1, -1)

    def frames_pool(kb):
        del lat[:]
        out = []
        for s in range(0, battery.shape[1], 256):
            t0 = time.perf_counter()
            out.append(kb.process(battery[:, s:s + 256]))
            lat.append((time.perf_counter() - t0) * 1e3)
        return np.concatenate(out, axis=1)

    def one_at_a_time(k):
        out = np.zeros_like(battery)
        for i, x in enumerate(streams):
            k.reset()
            out[i, :len(x)] = k.enhance(x)
        return out

    # (path, input, maker, call, the census's call, timed calls, battery delay)
    paths = [
        ("Koala.process", "mix stream 0, 376 frames", single, frames_one,
         lambda k: k.process(mix[0, :256].tolist()), 1, None),
        ("Koala.enhance", "mix stream 0, 6.0 s", single, lambda k: k.enhance(mix[0])[None],
         lambda k: k.enhance(mix[0]), SURFACE_REPS, None),
        ("Koala.enhance", "battery, 21 streams one at a time", single, one_at_a_time,
         lambda k: k.enhance(streams[0]), 1, 0),
        ("KoalaBatch.process", "battery B=21, 365 frames", pool(len(battery)), frames_pool,
         lambda kb: kb.process(battery[:, :256]), 1, DELAY_SAMPLE),
        ("process_chunk", "mix B=64 x 376", pool(B), lambda kb: kb.process_chunk(mix),
         lambda kb: kb.process_chunk(mix), SURFACE_REPS, None),
        ("process_chunk", "battery B=21 x 365", pool(len(battery)),
         lambda kb: kb.process_chunk(battery), lambda kb: kb.process_chunk(battery),
         SURFACE_REPS, DELAY_SAMPLE),
        ("enhance", "mix B=64 x 376", pool(B), lambda kb: kb.enhance(mix),
         lambda kb: kb.enhance(mix), SURFACE_REPS, None),
        ("enhance", "battery B=21 x 365", pool(len(battery)), lambda kb: kb.enhance(battery),
         lambda kb: kb.enhance(battery), SURFACE_REPS, 0),
    ]
    for name, label, make, call, census_call, reps, delay in paths:
        started = time.perf_counter()
        cpu = make("cpu")
        want = call(cpu)
        cpu.delete()
        inst = make("gpu")
        census_call(inst)                       # warm-up (lazy set-up)
        inst.reset()
        s = time.perf_counter()
        launches, port, port_want = traced(lambda: census_call(inst))
        census_s = time.perf_counter() - s
        runs, out = [], None
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls() as plain, CallCount(mmse_model, "apply_sequence") as seqs:
            for _ in range(reps):
                inst.reset()
                torch.cuda.synchronize()
                s = time.perf_counter()
                got = call(inst)
                runs.append((time.perf_counter() - s) * 1e3)
                if out is None:
                    out = got
                elif not np.array_equal(got, out):
                    failures.append("mmse %s (%s): two calls from a reset differ" % (name, label))
        launched = counts()
        inst.delete()
        db, least, lsb, share = card_vs_cpu(out, want)
        key = "%s (%s)" % (name, label)
        summary[key] = {"db": db, "least_stream_db": least, "max_lsb": lsb,
                        "share_over_2_lsb": share, "device_launches_per_call": launches,
                        "port_launches": port, "ms": runs, "plain_calls": plain.calls,
                        "sequence_calls": seqs.calls}
        if name.endswith("process"):            # a call is a frame: its latencies
            p50, p90 = np.percentile(lat, 50), np.percentile(lat, 90)
            summary[key].update(p50_ms=p50, p90_ms=p90)
            timing = "per frame p50 %.3f ms, p90 %.3f ms over %d frames" % (p50, p90, len(lat))
            if name == "Koala.process" and p50 >= 16.0:
                failures.append("mmse Koala.process: p50 %.3f ms a frame is not below 16 ms"
                                % p50)
        else:
            timing = "median %.3f ms, least %.3f of %d calls" % (statistics.median(runs),
                                                                 min(runs), reps)
        print("surface mmse %s (%s): card vs CPU %.2f dB (least stream %.2f), max|diff| %d LSB, "
              "%.2g of samples > 2 LSB; census %d device launches a call, %d of them the port's "
              "kernels; counters %s over %d sequence calls, plain-version calls %d; %s on %s "
              "(the check %.1f s, its trace %.1f s)"
              % (name, label, db, least, lsb, share, launches, port, launched, seqs.calls,
                 plain.calls, timing, card, time.perf_counter() - started, census_s))
        if db < CHUNK_SNR_DB or not only_mmse_kernels(launched, seqs.calls) or plain.calls \
                or port != port_want or name.endswith("process") == bool(seqs.calls):
            failures.append("mmse %s (%s): %.2f dB from the CPU, counters %s over %d sequence "
                            "calls, %d plain calls, %d port kernels traced for %d launches"
                            % (name, label, db, launched, seqs.calls, plain.calls, port,
                               port_want))
        if delay is not None:
            scored[key] = {n: figures(harness_results(
                *sets[n], *(out[3 * i + j, :lens[3 * i + j]] for j in range(3)), delay=delay))
                for i, n in enumerate(names)}

    # the battery's figures beside the CPU port's evaluate (for the record:
    # mmse is not held to mask_gru's gates or its ledger)
    tree, cfg = params_io.load_params(path)
    cpu_fig = {n: figures(evaluate(tree, cfg, *sets[n], device="cpu")) for n in names}
    for key, fig in [("CPU evaluate", cpu_fig)] + list(scored.items()):
        worst, low = max(names, key=lambda n: fig[n][0]), min(names, key=lambda n: fig[n][1])
        print("surface mmse battery %s: worst parity %.6f (%s), lowest SI-SDR gain %.4f dB (%s)"
              % (key, fig[worst][0], worst, fig[low][1], low))
        summary.setdefault(key, {}).update(worst_parity=[worst, fig[worst][0]],
                                           lowest_gain_db=[low, fig[low][1]])

    # the StreamingServer, 16 of the mix streams: backlog rounds, then live
    n_srv = SURFACE_SERVER_STREAMS
    rows = np.ascontiguousarray(mix[:n_srv].reshape(n_srv, T, 256))
    cpu = kt.create_batch(ACCESS_KEY, batch_size=n_srv, model_path=path, device="cpu")
    want = cpu.process_chunk(mix[:n_srv])
    cpu.delete()

    def server():
        return StreamingServer(ACCESS_KEY, num_streams=n_srv, model_path=path, device="gpu",
                               capacity_frames=T, chunk_frames=SERVE_CHUNK)

    warm = server()
    warm.push_block(rows[:, :SERVE_CHUNK], np.full(n_srv, SERVE_CHUNK, np.int32))
    pull_all(warm, n_srv, SERVE_CHUNK)
    steps = warm.stats["device_steps"]

    def one_round():
        warm.push_block(rows[:, SERVE_CHUNK:2 * SERVE_CHUNK], np.full(n_srv, SERVE_CHUNK, np.int32))
        pull_all(warm, n_srv, SERVE_CHUNK)

    launches, port, port_want = traced(one_round)
    per_round = launches / max(1, warm.stats["device_steps"] - steps)
    warm.close()
    srv = server()
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain, CallCount(mmse_model, "apply_sequence") as seqs:
        s = time.perf_counter()
        srv.push_block(rows, np.full(n_srv, T, np.int32))
        got = pull_all(srv, n_srv, T)
        wall = time.perf_counter() - s
    launched = counts()
    stats = srv.stats
    srv.close()
    db, least, lsb, share = card_vs_cpu(got.reshape(n_srv, -1), want)
    print("surface mmse StreamingServer backlog (%d streams x %d frames, chunk %d): %.1f audio-s/s "
          "(%.3f s wall), device steps %d, dropped %d / %d; card vs CPU process_chunk %.2f dB "
          "(least stream %.2f), max|diff| %d LSB, %.2g > 2 LSB; census %.1f device launches a "
          "round, %d the port's kernels; counters %s over %d sequence calls, plain-version calls "
          "%d on %s"
          % (n_srv, T, SERVE_CHUNK, n_srv * T * 256 / 16000.0 / wall, wall, stats["device_steps"],
             stats["dropped_samples"], stats["dropped_output_samples"], db, least, lsb, share,
             per_round, port, launched, seqs.calls, plain.calls, card))
    summary["StreamingServer backlog"] = {"audio_s_per_s": n_srv * T * 256 / 16000.0 / wall,
                                          "db": db, "max_lsb": lsb,
                                          "device_launches_per_round": per_round}
    if db < CHUNK_SNR_DB or not only_mmse_kernels(launched, seqs.calls) or plain.calls \
            or port != port_want or stats["dropped_samples"] or stats["dropped_output_samples"]:
        failures.append("mmse server backlog: %.2f dB from the CPU, counters %s, %d plain calls, "
                        "%d port kernels, stats %s" % (db, launched, plain.calls, port, stats))
    live_frames = int(SURFACE_LIVE_S * 1000 / 16)
    reset_counts()
    with PlainCalls() as plain, CallCount(mmse_model, "apply_sequence") as seqs:
        lat_ms, got, _, _, stats = live_cadence(server(), rows, live_frames)
    launched = counts()
    db, least, lsb, share = card_vs_cpu(got.reshape(n_srv, -1),
                                        want[:, 4 * 256:(4 + live_frames) * 256])
    p50, p90 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 90)
    print("surface mmse StreamingServer live (%d streams, a frame each every 16 ms for %.1f s): "
          "push-to-pull p50 %.3f ms, p90 %.3f ms over %d frames, device steps %d; card vs CPU "
          "%.2f dB (least stream %.2f), max|diff| %d LSB; counters %s, plain-version calls %d "
          "on %s" % (n_srv, SURFACE_LIVE_S, p50, p90, len(lat_ms), stats["device_steps"], db,
                     least, lsb, launched, plain.calls, card))
    summary["StreamingServer live"] = {"p50_ms": p50, "p90_ms": p90, "db": db, "max_lsb": lsb}
    if db < CHUNK_SNR_DB or p50 >= 16.0 or not only_mmse_kernels(launched, seqs.calls) \
            or plain.calls:
        failures.append("mmse server live: %.2f dB, p50 %.3f ms, counters %s over %d sequence "
                        "calls, %d plain calls" % (db, p50, launched, seqs.calls, plain.calls))
    return failures, summary


def surface_identity(kt, reset_counts, counts, pcm, battery, path):
    """Part 2: the identity model through ``create`` / ``create_batch`` on the
    card: every streaming entry must give the input back delayed by exactly
    ``delay_sample`` (silence before it), ``enhance`` the input itself, bit
    for bit, with no kernel but ``rowmm`` launched (the engine's STFT) and
    no plain version called. Returns (failures, summary)."""
    from koala_tpu_torch.constants import DELAY_SAMPLE

    x1 = pcm[:1, :T * 256 - 100]               # a length that is no whole number of frames
    xf = pcm[:1, :T * 256]
    failures, checked = [], []

    def check(entry, b, out, x, delayed):
        want = np.zeros_like(x)
        if delayed:
            want[:, DELAY_SAMPLE:] = x[:, :-DELAY_SAMPLE]
        else:
            want = x
        exact = out.shape == want.shape and np.array_equal(out, want)
        checked.append("%s B=%d %s" % (entry, b, "exact" if exact else "DIFFERS"))
        if not exact:
            failures.append("identity %s at B=%d is not the input%s, bit for bit"
                            % (entry, b, " delayed by %d" % DELAY_SAMPLE if delayed else ""))

    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain:
        k = kt.create(ACCESS_KEY, model_path=path, device="gpu")
        check("Koala.process", 1, np.asarray([k.process(xf[0, s:s + 256].tolist())
                                              for s in range(0, xf.shape[1], 256)],
                                             np.int16).reshape(1, -1), xf, True)
        k.reset()
        check("Koala.enhance", 1, k.enhance(x1[0])[None], x1, False)
        k.delete()
        for x in (xf, battery):
            b = x.shape[0]
            kb = kt.create_batch(ACCESS_KEY, batch_size=b, model_path=path, device="gpu")
            check("KoalaBatch.process", b, np.concatenate(
                [kb.process(x[:, s:s + 256]) for s in range(0, x.shape[1], 256)], axis=1), x, True)
            kb.reset()
            check("process_chunk", b, kb.process_chunk(x), x, True)
            kb.reset()
            check("enhance", b, kb.enhance(x[:, :-100]), x[:, :-100], False)
            kb.delete()
    launched = counts()
    print("surface identity (delay %d): %s; counters %s, plain-version calls %d"
          % (DELAY_SAMPLE, ", ".join(checked), launched, plain.calls))
    if not only_rowmm(launched) or plain.calls:
        failures.append("identity launched %s with %d plain calls" % (launched, plain.calls))
    return failures, {"checked": checked, "launches": launched}


def surface_snapshots(kt, card, reset_counts, counts, pcm, battery, path, totals):
    """Part 3: snapshots mid-stream. The bundled mask_gru model (all three
    kernels) and the mmse model, at B = 21 (the battery) and B = 64 (the
    mix), cut at frame ``SURFACE_CUT``: the first half, ``save_state``, then
    the second half (a) in the same card instance, (b) in a fresh card
    instance after ``load_state``, (c) in a CPU instance after
    ``load_state``, (d) on the card from the snapshot the CPU took after its
    own first half; once with ``process_chunk`` for both halves, once with
    ``enhance``. (b) must equal (a) bit for bit; (c) be >= CHUNK_SNR_DB from
    the CPU's uninterrupted run (both halves in one instance), (d) from the
    card's; every snapshot have the engine's keys and shapes with float32
    leaves. The card runs' launches add to ``totals``; the kernels are held
    against their plain versions on (b)'s inputs. Returns (failures,
    summary, recurrence holds, fused holds)."""
    from koala_tpu_torch.engine import core as engine_core
    from koala_tpu_torch.engine.stream import load_model
    from koala_tpu_torch.models import mask_gru as mask_gru_model
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.ops.kernels import engine_fused

    cut = SURFACE_CUT * 256
    failures, summary, held, fused_held = [], {}, {}, {}

    def counted(fn, recorders=()):
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.ExitStack() as stack:
            plain = stack.enter_context(PlainCalls())
            recs = [stack.enter_context(Recorder(m, name)) for m, name in recorders]
            out = fn()
            torch.cuda.synchronize()
        got = counts()
        for key, v in got.items():
            totals[key] += v
        return out, got, plain.calls, recs

    for model, model_path in (("mask_gru", params_io.default_model_path()), ("mmse", path)):
        engine, _ = load_model(model_path, "cpu")
        for x in (battery, pcm[:, :T * 256]):
            b = x.shape[0]
            layout = {k: v.shape for k, v in
                      params_io._flatten(engine.init_state((b,), "cpu")).items()}
            for mode in ("process_chunk", "enhance"):
                case = "%s B=%d %s" % (model, b, mode)

                def make(device, snap=None):
                    kb = kt.create_batch(ACCESS_KEY, batch_size=b, model_path=model_path,
                                         device=device)
                    if snap is not None:
                        kb.load_state(snap)
                    return kb

                def half(kb, second):
                    return getattr(kb, mode)(x[:, cut:] if second else x[:, :cut])

                card_a = make("gpu")
                counted(lambda: half(card_a, False))
                snap_card = card_a.save_state()
                second_a = counted(lambda: half(card_a, True))[0]
                card_a.delete()
                card_b = make("gpu", snap_card)
                recorders = ((mask_gru_model, "floor_scan"), (mask_gru_model, "gru_stack")) \
                    + (((engine_core, "fused_sequence"),) if mode == "enhance" else ())
                second_b, got_b, plain_b, recs = counted(
                    lambda: half(card_b, True), recorders if model == "mask_gru" else ())
                card_b.delete()
                cpu_a = make("cpu")
                half(cpu_a, False)
                snap_cpu = cpu_a.save_state()
                second_ca = half(cpu_a, True)
                cpu_a.delete()
                cpu_c = make("cpu", snap_card)
                second_c = half(cpu_c, True)
                cpu_c.delete()
                card_d = make("gpu", snap_cpu)
                second_d = counted(lambda: half(card_d, True))[0]
                card_d.delete()

                same = np.array_equal(second_b, second_a)
                c_db = card_vs_cpu(second_c, second_ca)
                d_db = card_vs_cpu(second_d, second_a)
                moved = {k: float(np.abs(v - snap_cpu[k]).max()) for k, v in snap_card.items()
                         if np.shape(v) == np.shape(snap_cpu.get(k))}
                bad_layout = [w for w, snap in (("card", snap_card), ("CPU", snap_cpu))
                              if {k: np.shape(v) for k, v in snap.items()} != layout
                              or any(np.asarray(v).dtype != np.float32 for v in snap.values())]
                want = {"floor_scan": 0, "gru_stack": 0, "engine_fused": 0, "mmse_gain": 1}
                if model == "mask_gru":
                    want = {"floor_scan": 1, "gru_stack": 1, "mmse_gain": 0,
                            "engine_fused": int(mode == "enhance")}
                    if mode == "enhance":
                        want["engine_fused_device"] = \
                            len(engine_fused.STAGES) * fused_segments(recs[2].args)
                launches_ok = all(got_b[k] == v for k, v in want.items()) \
                    and not got_b["gru_stack_hs"] and plain_b == 0
                print("surface snapshot %s, cut at frame %d: (b) fresh card instance after "
                      "load_state %s (a) bit for bit; (c) CPU after load_state %.2f dB (least "
                      "stream %.2f, max|diff| %d LSB) from the CPU's uninterrupted run; (d) card "
                      "from the CPU's snapshot %.2f dB (least %.2f, %d LSB) from the card's; "
                      "snapshot keys %s %s, card's against CPU's max|diff| %s; (b) launched %s, "
                      "plain-version calls %d on %s"
                      % (case, SURFACE_CUT, "equals" if same else "DIFFERS FROM", c_db[0],
                         c_db[1], c_db[2], d_db[0], d_db[1], d_db[2], sorted(layout),
                         "float32, shapes as the engine's" if not bad_layout
                         else "WRONG in %s" % bad_layout,
                         ", ".join("%s %.3g" % kv for kv in sorted(moved.items())), got_b,
                         plain_b, card))
                summary[case] = {"b_bit_exact": same, "c_db": c_db[0], "c_max_lsb": c_db[2],
                                 "d_db": d_db[0], "d_max_lsb": d_db[2], "launches_b": got_b,
                                 "c_least_stream_db": c_db[1], "d_least_stream_db": d_db[1],
                                 "snapshot_card_vs_cpu": moved}
                if not same or c_db[0] < CHUNK_SNR_DB or d_db[0] < CHUNK_SNR_DB or bad_layout \
                        or not launches_ok:
                    failures.append("snapshot %s: (b) bit-exact %s, (c) %.2f dB, (d) %.2f dB, "
                                    "layout wrong in %s, (b) launched %s with %d plain calls, "
                                    "expected %s" % (case, same, c_db[0], d_db[0], bad_layout,
                                                     got_b, plain_b, want))
                if model == "mask_gru":
                    # the kernels against their plain versions on (b)'s inputs
                    held["%s B=%d" % (mode, b)] = hold_recurrences(
                        "surface snapshot %s (b)" % case, recs[0], recs[1])
                    if mode == "enhance":
                        fused_held["enhance B=%d" % b] = hold_fused(
                            "surface snapshot %s (b)" % case, recs[2].args)[2]
    return failures, summary, held, fused_held


def ws_round_trip(port, pcm):
    """``pcm`` through the WebSocket protocol to the front on ``port``, as a
    browser sends it: the upgrade handshake, masked binary messages of 16
    frames, then the text "eof"; returns the binary replies up to "done"."""
    import base64
    import socket
    import struct

    from koala_tpu_torch.websocket import OP_BINARY, OP_CLOSE, OP_TEXT, recv_frame

    conn = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        key = base64.b64encode(os.urandom(16)).decode()
        conn.sendall(("GET / HTTP/1.1\r\nHost: 127.0.0.1:%d\r\nUpgrade: websocket\r\n"
                      "Connection: Upgrade\r\nSec-WebSocket-Key: %s\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n" % (port, key)).encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = conn.recv(4096)
            if not chunk:
                raise RuntimeError("the WebSocket front closed during the handshake")
            head += chunk
        if b" 101 " not in head.split(b"\r\n", 1)[0]:
            raise RuntimeError("the WebSocket front refused the upgrade: %r" % head[:200])

        def send(payload, opcode):
            mask = np.frombuffer(os.urandom(4), np.uint8)
            n = len(payload)
            hdr = struct.pack(">BB", 0x80 | opcode, 0x80 | n) if n < 126 \
                else struct.pack(">BBH", 0x80 | opcode, 0x80 | 126, n)
            body = np.frombuffer(payload, np.uint8) ^ np.resize(mask, n)
            conn.sendall(hdr + mask.tobytes() + body.tobytes())

        for i in range(0, len(pcm), 16 * 256):
            send(pcm[i:i + 16 * 256].astype("<i2").tobytes(), OP_BINARY)
        send(b"eof", OP_TEXT)
        out = []
        while True:
            opcode, payload = recv_frame(conn)
            if opcode is None or opcode == OP_CLOSE:
                raise RuntimeError("the WebSocket front closed before \"done\"")
            if opcode == OP_TEXT and payload == b"done":
                break
            if opcode == OP_BINARY:
                out.append(payload)
    finally:
        conn.close()
    return np.frombuffer(b"".join(out), "<i2")


def start_web_front(n_streams):
    """``scripts/serve_web_torch.py --device best`` on free ports with the
    bundled model and ``n_streams`` slots. Returns (process, HTTP port,
    WebSocket port)."""
    here = os.path.dirname(os.path.abspath(__file__))
    port, ws_port = free_port(), free_port()
    while ws_port == port:
        ws_port = free_port()
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "scripts", "serve_web_torch.py"), "--device", "best",
         "--port", str(port), "--ws-port", str(ws_port), "--streams", str(n_streams)],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, port, ws_port


def surface_websocket(card, battery, front):
    """Part 4: the 21 battery streams through the WebSocket front on the card
    (``start_web_front``), each from a client thread of its own, against a
    backlog run of an in-process StreamingServer on the same streams (the
    front's chunk and slots; a flush frame after each stream): every reply
    whole, aligned 1:1 and within ``WS_LSB`` (0) of the backlog run. Returns
    (failures, summary)."""
    import koala_tpu_torch as kt
    from koala_tpu_torch.serve import StreamingServer

    proc, port, ws_port = front
    nb, n = battery.shape
    frames = n // 256
    rows = np.zeros((nb, frames + 1, 256), np.int16)      # one zero frame flushes the tail
    rows[:, :frames] = battery.reshape(nb, frames, 256)

    def backlog(**kw):
        srv = StreamingServer(ACCESS_KEY, num_streams=nb, device="gpu",
                              capacity_frames=frames + 1, **kw)
        srv.push_block(rows, np.full(nb, frames + 1, np.int32))
        out = pull_all(srv, nb, frames + 1).reshape(nb, -1)
        srv.close()
        return out

    def spread(a, b):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return int(d.max()), int(np.count_nonzero(d))

    served = backlog()
    # two other ways of cutting the same streams into calls: the backlog's
    # rounds of 32 frames against one process_chunk call, and against rounds
    # of one frame (the step graph); both 0 LSB (the cuts phase holds them)
    kb = kt.create_batch(ACCESS_KEY, batch_size=nb, device="gpu")
    one_call = spread(served[:, :n], kb.process_chunk(battery))
    kb.delete()
    steps = spread(served, backlog(chunk_frames=1))
    print("surface websocket reference: the server's backlog run in rounds of 32 frames against "
          "one process_chunk call %d LSB (%d samples differ), against rounds of one frame "
          "(the step graph) %d LSB (%d differ) of %d samples on %s"
          % (one_call[0], one_call[1], steps[0], steps[1], nb * n, card))
    wait_for_port(proc, port, "serve_web_torch.py")
    replies, errors = [None] * nb, []

    def client(i):
        try:
            replies[i] = ws_round_trip(ws_port, battery[i])
        except (OSError, RuntimeError) as e:
            errors.append("stream %d: %s" % (i, e))

    s = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(nb)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=180)
    wall = time.perf_counter() - s
    whole = [r is not None and r.shape == (n,) for r in replies]
    diffs = [np.abs(r.astype(np.int32) - served[i, 256:256 + n])
             for i, r in enumerate(replies) if whole[i]]
    lsb = max((int(d.max()) for d in diffs), default=-1)
    differ = sum(int(np.count_nonzero(d)) for d in diffs)
    within = all(d.max() <= WS_LSB for d in diffs)
    print("surface websocket (scripts/serve_web_torch.py --device best, %d clients at once, "
          "%d samples each in masked messages of 16 frames): %d whole replies, aligned 1:1; "
          "from the server's backlog run: largest difference %d LSB (limit %d), %d samples "
          "differ of %d; %.3f s wall on %s"
          % (nb, n, sum(whole), lsb, WS_LSB, differ, nb * n, wall, card))
    if max(one_call[0], steps[0]) > WS_LSB:
        errors.append("websocket reference: the backlog run is %d LSB from one process_chunk "
                      "call and %d LSB from rounds of one frame" % (one_call[0], steps[0]))
    failures = errors + ([] if all(whole) and within and not any(
        th.is_alive() for th in threads) else ["websocket: %d of %d replies whole, %d LSB from "
                                                "the backlog run (%d samples differ)"
                                                % (sum(whole), nb, lsb, differ)])
    return failures, {"clients": nb, "max_lsb": lsb, "samples_differ": differ, "seconds": wall,
                      "backlog_vs_one_call": one_call, "backlog_vs_steps": steps}


def surface_phase(kt, card, reset_counts, counts, pcm):
    """Phase 2d: the rest of the public surface on the card, in four parts:
    the mmse model through every entry point and the server, the identity
    model through ``create`` / ``create_batch``, snapshots moved mid-stream
    between the card and the CPU, and the WebSocket front. Each part prints
    its lines (``surface ...``); a part that fails (or raises) fails the run
    after all four have printed. Returns the kernels' launches in the phase
    (the snapshot part's card runs) and what the kernels showed against their
    plain versions there."""
    from koala_tpu_torch.models import identity as identity_model
    from koala_tpu_torch.models import mmse as mmse_model
    from koala_tpu_torch.models import params_io

    bat = battery_streams(load_script("train_model_torch"))
    battery = bat[2]
    totals = dict.fromkeys(("floor_scan", "gru_stack", "gru_stack_hs", "engine_fused",
                            "engine_fused_device", "rowmm", "rowmm_simple", "mmse_gain"), 0)
    failures, summary, held, fused_held, front = [], {}, {}, {}, None
    with tempfile.TemporaryDirectory() as tmp:
        mmse_path = os.path.join(tmp, "mmse.pv")
        params_io.save_params(mmse_path, mmse_model.init_params(), mmse_model.DEFAULT_CONFIG)
        identity_path = os.path.join(tmp, "identity.pv")
        params_io.save_params(identity_path, identity_model.init_params(),
                              identity_model.DEFAULT_CONFIG)
        parts = [
            ("mmse", lambda: surface_mmse(kt, card, reset_counts, counts, pcm, bat, mmse_path)),
            ("identity", lambda: surface_identity(kt, reset_counts, counts, pcm, battery,
                                                  identity_path)),
            ("snapshot", lambda: surface_snapshots(kt, card, reset_counts, counts, pcm, battery,
                                                   mmse_path, totals)),
            ("websocket", lambda: surface_websocket(card, battery, front))]
        try:
            for name, part in parts:
                if name == "snapshot":
                    # the front starts in its own process while the snapshots run
                    front = start_web_front(len(battery))
                s = time.perf_counter()
                try:
                    part_failures, part_summary, *holds = part()
                except (Exception, SystemExit) as e:   # a part's fault fails the run, later
                    import traceback

                    traceback.print_exc()
                    part_failures, part_summary, holds = ["%s raised %r" % (name, e)], {}, []
                if holds:
                    held, fused_held = holds
                summary[name] = dict(part_summary, seconds=time.perf_counter() - s)
                print("surface %s: %s in %.1f s" % (name, "ok" if not part_failures else
                                                    "FAILED: " + "; ".join(part_failures),
                                                    time.perf_counter() - s), flush=True)
                failures += part_failures
        finally:
            if front is not None:
                stop(front[0])
    print(json.dumps({"surface": summary, "launches": totals, "card": card}), flush=True)
    if failures:
        fail("surface: " + "; ".join(failures))
    return totals, held, fused_held


def cuts_part(kt, card, reset_counts, counts, path, x, totals):
    """One part of the cuts phase: the streams ``x`` [n, frames x 256] int16
    through the model at ``path``, every way of cutting them into calls
    against one ``process_chunk`` call, bit for bit. Returns (failures,
    summary)."""
    from koala_tpu_torch import serve
    from koala_tpu_torch.serve import StreamingServer

    nb, width = x.shape
    frames = width // 256
    rows = np.ascontiguousarray(x.reshape(nb, frames, 256))
    failures, ways = [], {}

    def counted(fn):
        """fn() with the counters set to 0 just before and read just after,
        and the plain-version calls in it."""
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls() as plain:
            out = fn()
            torch.cuda.synchronize()
        got = counts()
        for key, v in got.items():
            totals[key] += v
        return out, got, plain.calls

    def held(way, got, want, launched, plain_calls, **extra):
        d = np.abs(got.astype(np.int32) - want.astype(np.int32)) if got.shape == want.shape \
            else np.full(1, -1)
        ways[way] = dict({"max_lsb": int(d.max()), "samples_differ": int(np.count_nonzero(d)),
                          "samples": int(d.size), "launches": launched,
                          "plain_calls": plain_calls}, **extra)
        if got.shape != want.shape or d.max() != 0 or plain_calls:
            failures.append("%s: %s LSB on %d of %d samples, %d plain-version calls"
                            % (way, int(d.max()), int(np.count_nonzero(d)), d.size, plain_calls))

    kb = kt.create_batch(ACCESS_KEY, batch_size=nb, model_path=path, device="gpu")
    kb.process_chunk(x[:, :8 * 256])           # warm-up (lazy set-up)
    chunk_ms, want = [], None
    for _ in range(CUTS_CHUNK_REPS):
        kb.reset()
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = kb.process_chunk(x)
        chunk_ms.append((time.perf_counter() - s) * 1e3)
        if want is None:
            want = out
        elif not np.array_equal(out, want):
            failures.append("two process_chunk calls from a reset differ")

    # the server: backlog in rounds of 32 and of 8 frames, single-frame rounds
    for chunk in (32, 8, 1):
        srv = StreamingServer(ACCESS_KEY, num_streams=nb, model_path=path, device="gpu",
                              capacity_frames=frames, chunk_frames=chunk)
        captures, replays = serve.graph_captures, serve.graph_replays

        def backlog():
            srv.push_block(rows, np.full(nb, frames, np.int32))
            return pull_all(srv, nb, frames)

        got, launched, plain_calls = counted(backlog)
        stats = srv.stats
        srv.close()
        held("server rounds of %d" % chunk, got.reshape(nb, -1), want, launched, plain_calls,
             rounds=stats["device_steps"], graph_captures=serve.graph_captures - captures,
             graph_replays=serve.graph_replays - replays)

    # the server's live rounds: every stream a frame every 16 ms (after four
    # single-frame rounds), the frames that come back against the same frames
    # of the call
    live_frames = int(CUTS_LIVE_S * 1000 / 16)
    srv = StreamingServer(ACCESS_KEY, num_streams=nb, model_path=path, device="gpu",
                          capacity_frames=frames)
    (lat_ms, got, _, _, stats), launched, plain_calls = counted(
        lambda: live_cadence(srv, rows, live_frames))
    live = {"p50_ms": float(np.percentile(lat_ms, 50)), "p90_ms": float(np.percentile(lat_ms, 90))}
    held("server live rounds", got.reshape(nb, -1),
         want[:, 4 * 256:(4 + live_frames) * 256], launched, plain_calls,
         rounds=stats["device_steps"], **live)
    if live["p50_ms"] >= 16.0:
        failures.append("live p50 %.3f ms is not below 16 ms" % live["p50_ms"])

    # T KoalaBatch.process calls
    kb.reset()
    got, launched, plain_calls = counted(lambda: np.concatenate(
        [kb.process(x[:, j * 256:(j + 1) * 256]) for j in range(frames)], axis=1))
    held("KoalaBatch.process x %d" % frames, got, want, launched, plain_calls,
         gru_launches_a_step=launched["gru_stack"] / frames)
    kb.delete()

    # Koala.process frame by frame on a few of the streams, each frame timed
    k = kt.create(ACCESS_KEY, model_path=path, device="gpu")
    k.process(x[0, :256].tolist())             # warm-up (lazy set-up)
    picked = np.linspace(0, nb - 1, CUTS_STREAMS).astype(int)
    lat = []

    def frame_by_frame():
        out = []
        for i in picked:
            k.reset()
            for j in range(frames):
                s = time.perf_counter()
                out.append(k.process(x[i, j * 256:(j + 1) * 256].tolist()))
                lat.append((time.perf_counter() - s) * 1e3)
        return np.asarray(out, np.int16).reshape(len(picked), -1)

    got, launched, plain_calls = counted(frame_by_frame)
    process = {"p50_ms": float(np.percentile(lat, 50)), "p90_ms": float(np.percentile(lat, 90))}
    held("Koala.process x %d on streams %s" % (frames, picked.tolist()), got, want[picked],
         launched, plain_calls, gru_launches_a_step=launched["gru_stack"] / got.size * 256,
         **process)
    if process["p50_ms"] >= 16.0:
        failures.append("Koala.process p50 %.3f ms is not below 16 ms" % process["p50_ms"])

    # one stream's Koala.enhance: its aligned output against the call's,
    # on the samples both compute
    i = int(picked[-1])
    k.reset()
    got, launched, plain_calls = counted(lambda: k.enhance(x[i]))
    held("Koala.enhance of stream %d" % i, got[:width - 256], want[i, 256:], launched,
         plain_calls)
    k.delete()

    gru_step = ways["KoalaBatch.process x %d" % frames]["gru_launches_a_step"]
    summary = {"streams": nb, "frames": frames, "ways": ways,
               "process_chunk_ms": {"median": statistics.median(chunk_ms), "least": min(chunk_ms),
                                    "calls": len(chunk_ms)},
               "gru_launches_an_eager_step": gru_step, "Koala.process": process,
               "server_live": live}
    for way, v in ways.items():
        rounds = "; %d rounds" % v["rounds"] if "rounds" in v else ""
        if v.get("graph_replays"):
            rounds += ", step graph captured %d time(s) and replayed %d times" % (
                v["graph_captures"], v["graph_replays"])
        print("cuts   %-40s max|diff| %d LSB, %d of %d samples differ; launches %s, plain-version "
              "calls %d%s" % (way, v["max_lsb"], v["samples_differ"], v["samples"],
                              v["launches"], v["plain_calls"], rounds))
    print("cuts   process_chunk at B=%d x T=%d: median %.2f ms, least %.2f of %d calls; an eager "
          "step launches the GRU kernel %g time(s); Koala.process p50 %.3f ms, p90 %.3f ms a "
          "frame; the server's live p50 %.3f ms, p90 %.3f ms on %s"
          % (nb, frames, summary["process_chunk_ms"]["median"], min(chunk_ms), len(chunk_ms),
             gru_step, process["p50_ms"], process["p90_ms"], live["p50_ms"], live["p90_ms"],
             card))
    return failures, summary, gru_step


def cuts_phase(kt, card, reset_counts, counts, pcm):
    """Phase 2e: a stream's output against how it is cut into calls, in
    three parts: the bundled model on the battery's 21 streams and on the
    mix (B = 64 x 376), and mmse on the battery. In each, the server's
    backlog in rounds of 32 and of 8 frames, its single-frame rounds (the
    step graph), its live rounds, T ``KoalaBatch.process`` calls,
    ``Koala.process`` frame by frame on ``CUTS_STREAMS`` streams and one
    stream's ``Koala.enhance`` must give one ``process_chunk`` call's int16
    bit for bit, and call no plain version; an eager step of the bundled
    model launches the GRU kernel once (a launch plan at B = 1, 21 and 64),
    mmse's never. Each part prints its lines (``cuts ...``); a part that
    fails (or raises) fails the run after all three have printed. Returns
    the kernels' launches in the phase."""
    from koala_tpu_torch.models import mmse as mmse_model
    from koala_tpu_torch.models import params_io

    battery = battery_streams(load_script("train_model_torch"))[2]
    totals = dict.fromkeys(("floor_scan", "gru_stack", "gru_stack_hs", "engine_fused",
                            "engine_fused_device", "rowmm", "rowmm_simple", "mmse_gain"), 0)
    failures, summary = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        mmse_path = os.path.join(tmp, "mmse.pv")
        params_io.save_params(mmse_path, mmse_model.init_params(), mmse_model.DEFAULT_CONFIG)
        bundled = params_io.default_model_path()
        parts = (("mask_gru battery B=%d" % len(battery), bundled, battery, 1),
                 ("mask_gru mix B=%d" % B, bundled, pcm[:, :T * 256], 1),
                 ("mmse battery B=%d" % len(battery), mmse_path, battery, 0))
        for name, path, x, gru_step_want in parts:
            s = time.perf_counter()
            try:
                part_failures, part_summary, gru_step = cuts_part(
                    kt, card, reset_counts, counts, path, x, totals)
                if gru_step != gru_step_want:
                    part_failures.append("an eager step launched the GRU kernel %g times, not %d"
                                         % (gru_step, gru_step_want))
            except (Exception, SystemExit) as e:   # a part's fault fails the run, later
                import traceback

                traceback.print_exc()
                part_failures, part_summary = ["%s raised %r" % (name, e)], {}
            summary[name] = dict(part_summary, seconds=time.perf_counter() - s)
            print("cuts %s: %s in %.1f s" % (name, "ok: every way bit for bit" if not part_failures
                                            else "FAILED: " + "; ".join(part_failures),
                                            time.perf_counter() - s), flush=True)
            failures += ["%s: %s" % (name, f) for f in part_failures]
    print(json.dumps({"cuts": summary, "launches": totals, "card": card}), flush=True)
    if failures:
        fail("cuts: " + "; ".join(failures))
    return totals


def mmse_gain_phase(card, reset_counts, counts):
    """Phase 12b: the mmse gain kernel (csrc/mmse.cu) held bit for bit to its
    plain version on the card, masks and every state leaf, at the corpus
    wash's [8192, 375, 257] and ``process_chunk``'s [64, 376, 257], each with
    its CUDA-event time beside its bound and the plain loop's time
    (``scripts/mmse_times_torch.py``'s ``measure``): a ``mmse_gain ...``
    line a shape and a ``{"mmse_gain": ...}`` JSON line. Then the path the
    kernel serves, ``CorpusRunner.enhance_batch`` with ``mmse`` on
    ``MMSE_RUNNER_B`` streams of 375 frames: one gain launch a batch, ``rowmm``
    and no other kernel, no plain version, and the same bits as the batch
    with the plain version in the kernel's place (a ``mmse_gain corpus
    runner`` line). Returns the kernel's entry of the ``kernels`` line."""
    from koala_tpu_torch.models import mmse as mmse_model
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    before = mmse_kernel.launches
    entries = load_script("mmse_times_torch").measure(torch.device("cuda", 0))
    for e in entries:
        print("mmse_gain [%d, %d, %d]: bits %s the plain version's; %.4f ms%s, bound %.4f ms "
              "(%s), %.1f%% of it, %.0f GB/s; the plain loop %.2f ms on %s"
              % (e["streams"], e["frames"], e["bins"],
                 "equal to" if e["bits_equal"] else "DIFFER (%s) from" % e["differ"], e["ms"],
                 " queued" if e["queued"] else "", e["bound_ms"], e["bound_by"],
                 e["roofline_pct"], e["gb_per_s"], e["plain_ms"], card))
    print("mmse_gain: the hold above made %d launches" % (mmse_kernel.launches - before))
    print(json.dumps({"mmse_gain": entries, "card": card}), flush=True)
    bad = [e for e in entries if not e["bits_equal"]]
    if bad:
        fail("mmse_gain: the kernel differs from its plain version at %s"
             % [(e["streams"], e["frames"], e["differ"]) for e in bad])

    pcm = mix_streams(375 * 256)[:MMSE_RUNNER_B].astype(np.float32) / 32768.0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mmse.pv")
        params_io.save_params(path, mmse_model.init_params(), mmse_model.DEFAULT_CONFIG)
        runner = CorpusRunner(path, global_batch=MMSE_RUNNER_B, utterance_samples=375 * 256,
                              mesh=make_mesh(["gpu:0"]))
    runner.enhance_batch(pcm)                    # warm-up (lazy set-up)
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain:
        out = [runner.enhance_batch(pcm).clone() for _ in range(MMSE_RUNNER_BATCHES)]
        torch.cuda.synchronize()
    launched = counts()
    kernel = mmse_kernel.mmse_gain
    mmse_kernel.mmse_gain = mmse_kernel.mmse_gain_ref
    try:
        want = runner.enhance_batch(pcm)
    finally:
        mmse_kernel.mmse_gain = kernel
    same = all(torch.equal(o, want) for o in out)
    print("mmse_gain corpus runner: %d batches of %d x 375 frames, launches %s, %d plain calls, "
          "bits %s the plain version's on %s"
          % (MMSE_RUNNER_BATCHES, MMSE_RUNNER_B, launched, plain.calls,
             "equal to" if same else "DIFFER from", card), flush=True)
    if not only_mmse_kernels(launched, MMSE_RUNNER_BATCHES) or plain.calls:
        fail("mmse_gain: the corpus runner's batches should launch rowmm and the gain kernel "
             "once a batch, no other kernel and no plain version: %s, %d plain calls"
             % (launched, plain.calls))
    if not same:
        fail("mmse_gain: the corpus runner's batch with the kernel is not the batch with its "
             "plain version")
    wash = entries[0]
    return {"name": "mmse_gain", "route": "cuda", "source": "koala_tpu_torch/csrc/mmse.cu",
            "replaces": None, "ms": wash["ms"], "plain_ms": wash["plain_ms"],
            "library_ms": None, "bound_ms": wash["bound_ms"], "bound_by": wash["bound_by"],
            "shape": [wash["streams"], wash["frames"], wash["bins"]], "shapes": entries,
            "launches_by_path": {"corpus_runner": launched["mmse_gain"]}}


# the corpus runner's batch of mmse streams in phase 12b, and the batches counted
MMSE_RUNNER_B = 64
MMSE_RUNNER_BATCHES = 2


# FullSubNet's phase: the LSTM kernel's widths (kx, H) and the rows it takes at
# the benchmark's batch of 2048 streams (the full band a row a stream, the
# sub-band 257), and Demucs's layer-step (a row a stream, depth 2048: K-panels)
LSTM_SHAPES = (("fullband", 257, 512, 2048), ("fullband", 512, 512, 2048),
               ("subband", 32, 384, 2048 * 257), ("subband", 384, 384, 2048 * 257),
               ("demucs", 1024, 1024, 2048))
LSTM_ATOL = 2e-5               # h' and c' against the plain version (sums in another order)
FSN_B = 64                     # the corpus runner's batch that one stream's process is held to


def lstm_library_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    """An LSTM layer-step from library calls (cuBLAS products on bf16
    operands, torch's elementwise gates): the yardstick of the kernel's time."""
    gates = (torch.matmul(x.bfloat16(), w_ih.t().bfloat16()).float()
             + torch.matmul(h.bfloat16(), w_hh.t().bfloat16()).float() + b_ih + b_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_case(lstm, kx, h, rows, dev):
    """Weights at PyTorch's default scale and a [rows, 2, H] state, as the
    model hands over one layer's rows: (x, h, c, w, b, (w_ih, w_hh, b_ih, b_hh))."""
    g = torch.Generator().manual_seed(kx * 1000 + h)
    raw = tuple(((torch.rand(shape, generator=g) * 2 - 1) / h ** 0.5).to(dev)
                for shape in ((4 * h, kx), (4 * h, h), (4 * h,), (4 * h,)))
    w, b = lstm.stack_weights(*raw)
    state = torch.randn(rows, 2, h, device=dev)
    return torch.randn(rows, kx, device=dev), state[:, 1], state[:, 0] * 2, w, b, raw


def fullsubnet_phase(kt, dev, card):
    """Phase 12: FullSubNet (models/fullsubnet.py) and its LSTM-cell kernel
    (csrc/lstm.cu). The kernel against its plain version at each of the
    model's four widths and at Demucs's (kx = H = 1024, in K-panels), at 1,
    64, 127, 128, 129, 257 and the benchmark's rows (2048 full-band and
    Demucs, 526,336 sub-band) and 29 fewer, a row's bits the same at every
    row count, and each width's plan and time beside its bound, the plain
    version's and the library's (cuBLAS bf16 products and torch's
    elementwise gates); one stream's
    ``Koala.process`` bit for bit its row of ``CorpusRunner.enhance_batch``
    at B = 64; the ``StreamingServer`` (full-chunk and single-frame rounds)
    bit for bit ``Koala.process``; ``mask_gru`` and ``mmse`` with their masks
    handed to the engine as (mask, 0) bit for bit as real masks. Returns the
    kernel's entry of the ``kernels`` line."""
    from koala_tpu_torch.models import mmse as mmse_model
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.engine.core import make_engine
    from koala_tpu_torch.ops.kernels import lstm
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh
    from koala_tpu_torch.profiling import time_ms
    from koala_tpu_torch.serve import StreamingServer

    here = os.path.dirname(os.path.abspath(__file__))
    model = os.path.join(here, "models", "fullsubnet", "fullsubnet_random.pv")
    lstm.launches = 0
    rows_out, worst = [], 0.0
    for band, kx, h, big in LSTM_SHAPES:
        x, h0, c0, w, b, raw = lstm_case(lstm, kx, h, big, dev)
        full_h, full_c = lstm.lstm_cell(x, h0, c0, w, b)
        for rows in (1, 64, 127, 128, 129, 257, big - 29, big):
            part_h, part_c = lstm.lstm_cell(x[:rows], h0[:rows], c0[:rows], w, b)
            if not (torch.equal(part_h, full_h[:rows]) and torch.equal(part_c, full_c[:rows])):
                fail("lstm %s kx %d: a row's bits at %d rows differ from %d rows"
                     % (band, kx, rows, big))
            ref_h, ref_c = lstm.lstm_cell_ref(x[:rows], h0[:rows], c0[:rows], w, b)
            err = max(float((part_h - ref_h).abs().max()), float((part_c - ref_c).abs().max()))
            worst = max(worst, err)
            if not err < LSTM_ATOL:
                fail("lstm %s kx %d at %d rows: %.3g from the plain version"
                     % (band, kx, rows, err))
        out_h, out_c = torch.empty_like(full_h), torch.empty_like(full_c)
        ms = time_ms(lambda: lstm.lstm_cell(x, h0, c0, w, b, out_h, out_c), 5)
        plain_ms = time_ms(lambda: lstm.lstm_cell_ref(x, h0, c0, w, b), 1, 1)
        library_ms = time_ms(lambda: lstm_library_cell(x, h0, c0, *raw), 5)
        bound = lstm.bound(big, kx, h)
        flops = 2 * big * (kx + h) * 4 * h
        rows_out.append({"band": band, "kx": kx, "H": h, "rows": big, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get),
                         "tflops": flops / ms / 1e9, "plan": list(lstm.plan(big, kx, h))})
        print("lstm %s kx %d H %d rows %d: plan (tile rows, passes a block, groups) %s, ms %.4f "
              "bound_ms %.4f (%s) plain_ms %.2f library_ms %.4f, %.1f TFLOP/s, max|err| %.3g on %s"
              % (band, kx, h, big, lstm.plan(big, kx, h), ms, max(bound.values()),
                 max(bound, key=bound.get), plain_ms, library_ms, flops / ms / 1e9, err, card),
              flush=True)
        del x, h0, c0, full_h, full_c, out_h, out_c

    # one stream's Koala.process against its row of the corpus runner's batch
    pcm = mix_streams(375 * 256)[:FSN_B]
    runner = CorpusRunner(model, global_batch=FSN_B, utterance_samples=375 * 256,
                          mesh=make_mesh(["gpu:0"]))
    before = lstm.launches
    out = runner.enhance_batch(pcm.astype(np.float32) / 32768.0)
    torch.cuda.synchronize()
    runner_launches = lstm.launches - before
    if runner_launches != 4 * 375:
        fail("the corpus runner's batch made %d LSTM launches, not 4 a hop" % runner_launches)
    rows = np.clip(np.round(out[:2].reshape(2, -1).cpu().numpy().astype(np.float64) * 32768.0),
                   -32768, 32767).astype(np.int16)
    process = []
    before = lstm.launches
    for s in range(2):
        k = kt.create(ACCESS_KEY, model_path=model, device="gpu")
        process.append(np.concatenate([k.process(pcm[s, i:i + 256])
                                       for i in range(0, pcm.shape[1], 256)]))
        k.delete()
        if not np.array_equal(process[s], rows[s]):
            fail("fullsubnet: stream %d's Koala.process is %d LSB from its row of the corpus "
                 "runner" % (s, int(np.abs(process[s].astype(np.int32) - rows[s]).max())))
    process_launches = lstm.launches - before
    print("fullsubnet: Koala.process (2 streams x 375 frames, %d LSTM launches) bit for bit "
          "the rows of CorpusRunner.enhance_batch at B = %d (%d launches) on %s"
          % (process_launches, FSN_B, runner_launches, card))

    # the server: uneven pushes, so that rounds of full chunks and of single
    # frames (the captured step graph) both run
    n = 100 * 256
    server = StreamingServer(ACCESS_KEY, model_path=model, device="gpu", num_streams=2,
                             chunk_frames=8)
    try:
        for s in range(2):
            server.push(s, pcm[s, :(37 + 13 * s) * 256])
        time.sleep(0.5)
        for s in range(2):
            server.push(s, pcm[s, (37 + 13 * s) * 256:n])
        for s in range(2):
            got, deadline = [], time.time() + 120
            while sum(len(g) for g in got) < n and time.time() < deadline:
                chunk = server.pull(s)
                if len(chunk):
                    got.append(chunk)
                else:
                    time.sleep(0.005)
            got = np.concatenate(got) if got else np.zeros((0,), np.int16)
            if not np.array_equal(got, process[s][:n]):
                fail("fullsubnet: the server's stream %d is not Koala.process's" % s)
    finally:
        server.close()
    print("fullsubnet: StreamingServer (chunks of 8, uneven pushes) bit for bit Koala.process "
          "on %s" % card)

    # a real mask and the same mask as (mask, 0): the same bits on the card
    bundled = params_io.load_params(params_io.default_model_path())
    for kind, (tree, cfg) in (("mask_gru", bundled),
                              ("mmse", ({"empty": np.zeros((1,), np.float32)},
                                        dict(mmse_model.DEFAULT_CONFIG)))):
        eng = make_engine(kind, cfg)
        params = params_io.params_from_numpy(tree, dev, kind)
        hops = torch.as_tensor(pcm[:8, :64 * 256].reshape(8, 64, 256) / 32768.0,
                               dtype=torch.float32, device=dev)
        real_model = eng.model

        def run():
            with torch.inference_mode():
                _, seq = eng.sequence(params, eng.init_state((8,), dev), hops)
                st, outs = eng.init_state((8,), dev), []
                for t in range(4):
                    st, o = eng.step(params, st, hops[:, t])
                    outs.append(o)
            return seq, torch.stack(outs, 1)

        real = run()

        class Complex:
            init_state = real_model.init_state

            @staticmethod
            def step(*a):
                st, m = real_model.step(*a)
                return st, (m, torch.zeros_like(m))

            @staticmethod
            def apply_sequence(*a):
                st, m = real_model.apply_sequence(*a)
                return st, (m, torch.zeros_like(m))
        eng.model = Complex
        try:
            cplx = run()
        finally:
            eng.model = real_model
        if not (torch.equal(real[0], cplx[0]) and torch.equal(real[1], cplx[1])):
            fail("%s: a complex mask (mask, 0) changes the output" % kind)
    print("fullsubnet: mask_gru and mmse with their masks as (mask, 0) bit for bit as real "
          "masks on %s" % card)
    times = ("ms", "plain_ms", "library_ms", "bound_ms")
    frame = {k: sum(r[k] for r in rows_out if r["band"] != "demucs") for k in times}
    hop = {k: 2 * r[k] for r in rows_out if r["band"] == "demucs" for k in times}
    entry = {"name": "lstm_cell", "route": "cuda", "source": "koala_tpu_torch/csrc/lstm.cu",
             "replaces": None, "launches": lstm.launches, "max_abs_err": worst,
             "launches_by_path": {"corpus_runner": runner_launches,
                                  "Koala.process": process_launches},
             **frame, "bound_by": "the four layer-steps of a frame at B = 2048, each at its own",
             "shape": [2048, 257], "widths": rows_out, "demucs_hop_at_b2048": hop}
    print(json.dumps({"fullsubnet": {"lstm": rows_out, "frame_at_b2048": frame,
                                     "demucs_hop_at_b2048": hop,
                                     "process_equals_runner": True, "server_equals_process": True,
                                     "complex_mask_zero_imag_equal": True}}))
    return entry


# Demucs's phase: the cell's batch (blocks of ``block_hops`` = 8 hops), the
# streams whose Koala.process is held to their rows
DEMUCS_B = 2048
DEMUCS_PROCESS_STREAMS = 2
# launches in that batch: rowmm's (25 products a block of 8 hops, 47 blocks),
# of them its fused entry's (each level's strided convolution and two 1x1s),
# the overlap passes (one a level) and the LSTM's (two a hop)
DEMUCS_ROWMM, DEMUCS_FUSED, DEMUCS_OVERLAP, DEMUCS_LSTM = 47 * 25, 47 * 15, 47 * 5, 2 * 375
# a hop of one stream's Koala.process: the fused entry's launches (its
# narrow kernels at every level) and the overlap passes
DEMUCS_FUSED_HOP, DEMUCS_OVERLAP_HOP = 15, 5


def demucs_phase(kt, card, reset_counts, counts):
    """Phase 12c: Demucs (models/demucs.py) at dns64's widths, its weights
    drawn from ``benchmark/configs/demucs-dns64.json``'s seed, on the
    benchmark cell's path: one ``CorpusRunner.enhance_batch`` of DEMUCS_B x
    375 hops after a warm-up, the counts reset just before it: DEMUCS_LSTM
    LSTM launches, DEMUCS_ROWMM ``rowmm`` launches of which DEMUCS_FUSED of
    its fused entry, DEMUCS_OVERLAP overlap passes, no other counted kernel
    and no plain version; the same batch through the plain U-Net
    (``_encoder_plain``, ``_decoder_plain``) bit for bit; then two streams'
    ``Koala.process``, hop by hop, bit for bit their rows of that batch, with
    DEMUCS_FUSED_HOP launches of the fused entry (its narrow kernels) and
    DEMUCS_OVERLAP_HOP overlap passes a hop and no plain version (a ``demucs
    corpus runner`` line); then each fused product and overlap pass of one
    block of the cell (2048 x 8 hops) held bit for bit to its plain version
    and timed beside its bound (``scripts/unet_fused_times_torch.py``'s
    ``measure``, a ``demucs ...`` line each). Returns the LSTM launches by
    path and the ``kernels`` line's ``rowmm_fused`` and ``overlap_add``
    entries."""
    from koala_tpu_torch.models import demucs, params_io
    from koala_tpu_torch.models.base import Placeholder
    from koala_tpu_torch.ops.kernels import lstm, overlap, rowmm
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "benchmark", "configs", "demucs-dns64.json")) as f:
        cfg = json.load(f)["model"]
    pcm = mix_streams(375 * 256)
    pcm = np.tile(pcm, (-(-DEMUCS_B // len(pcm)), 1))[:DEMUCS_B]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dns64.pv")
        params_io.save_params(path, Placeholder(), cfg)
        runner = CorpusRunner(path, global_batch=DEMUCS_B, utterance_samples=375 * 256,
                              mesh=make_mesh(["gpu:0"]))
        batch = pcm.astype(np.float32) / 32768.0
        runner.enhance_batch(batch)                 # warm-up (lazy set-up)
        torch.cuda.synchronize()
        reset_counts()
        before, fused, tails = lstm.launches, rowmm.fused_launches, overlap.launches
        t0 = time.perf_counter()
        with PlainCalls() as plain:
            out = runner.enhance_batch(batch).clone()
            torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        launched = counts()
        runner_launches = lstm.launches - before
        fused, tails = rowmm.fused_launches - fused, overlap.launches - tails
        stages = demucs._encoder, demucs._decoder
        demucs._encoder, demucs._decoder = demucs._encoder_plain, demucs._decoder_plain
        try:
            t0 = time.perf_counter()
            plain_out = runner.enhance_batch(batch)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        finally:
            demucs._encoder, demucs._decoder = stages
        plain_equal = torch.equal(out, plain_out)
        rows = np.clip(np.round(out[:DEMUCS_PROCESS_STREAMS].reshape(DEMUCS_PROCESS_STREAMS, -1)
                                .cpu().numpy().astype(np.float64) * 32768.0),
                       -32768, 32767).astype(np.int16)
        del runner, out, plain_out
        before = lstm.launches, rowmm.fused_launches, overlap.launches
        with PlainCalls() as process_plain:
            for s in range(DEMUCS_PROCESS_STREAMS):
                k = kt.create(ACCESS_KEY, model_path=path, device="gpu")
                try:
                    if k.delay_sample != 768:
                        fail("demucs: Koala.delay_sample is %d, not 768" % k.delay_sample)
                    got = np.concatenate([k.process(pcm[s, i:i + 256])
                                          for i in range(0, pcm.shape[1], 256)])
                finally:
                    k.delete()
                if not np.array_equal(got, rows[s]):
                    lsb = int(np.abs(got.astype(np.int32) - rows[s]).max())
                    fail("demucs: stream %d's Koala.process is %d LSB from its row of the "
                         "corpus runner" % (s, lsb))
        process_launches, process_fused, process_tails = (
            lstm.launches - before[0], rowmm.fused_launches - before[1],
            overlap.launches - before[2])
    print("demucs corpus runner: %d x 375 hops in %.3f s (the plain U-Net %.3f s, bit for bit "
          "%s), launches %s, %d of rowmm's fused entry, %d overlap passes and %d LSTM, %d plain "
          "calls; Koala.process (%d streams, %d LSTM launches, %d fused, %d overlap, %d plain "
          "calls) bit for bit their rows on %s"
          % (DEMUCS_B, batch_s, plain_s, plain_equal, launched, fused, tails, runner_launches,
             plain.calls, DEMUCS_PROCESS_STREAMS, process_launches, process_fused,
             process_tails, process_plain.calls, card), flush=True)
    if (runner_launches != DEMUCS_LSTM or not only_rowmm(launched)
            or launched["rowmm"] != DEMUCS_ROWMM or fused != DEMUCS_FUSED
            or tails != DEMUCS_OVERLAP or plain.calls):
        fail("demucs: the corpus runner's batch should launch the LSTM kernel %d times, rowmm "
             "%d times (%d of them its fused entry), the overlap pass %d times, no other kernel "
             "and no plain version: %d LSTM, %s, %d fused, %d overlap, %d plain calls"
             % (DEMUCS_LSTM, DEMUCS_ROWMM, DEMUCS_FUSED, DEMUCS_OVERLAP, runner_launches,
                launched, fused, tails, plain.calls))
    if not plain_equal:
        fail("demucs: the corpus runner's batch differs from the same batch through the plain "
             "U-Net")
    if process_launches != DEMUCS_PROCESS_STREAMS * DEMUCS_LSTM:
        fail("demucs: Koala.process made %d LSTM launches, not two a hop" % process_launches)
    hops = DEMUCS_PROCESS_STREAMS * 375
    if (process_fused != DEMUCS_FUSED_HOP * hops or process_tails != DEMUCS_OVERLAP_HOP * hops
            or process_plain.calls):
        fail("demucs: one stream's Koala.process should launch rowmm's fused entry %d times and "
             "the overlap pass %d times a hop, and no plain version: %d fused, %d overlap over "
             "%d hops, %d plain calls" % (DEMUCS_FUSED_HOP, DEMUCS_OVERLAP_HOP, process_fused,
                                          process_tails, hops, process_plain.calls))

    # the fused products and overlap passes of one block of the cell, each
    # held to its plain version on the same inputs
    entries = load_script("unet_fused_times_torch").measure(torch.device("cuda", 0))
    for e in entries:
        print("demucs %-9s %-8s %8.4f ms, bound %.4f ms (%s), %.1f%% of it; plain %.4f ms; bits "
              "%s on %s" % (e["product"], e["kind"], e["ms"], e["bound_ms"], e["bound_by"],
                            e["roofline_pct"], e["plain_ms"],
                            "equal" if e["bits_equal"] else "DIFFER", card))
    bad = [e["product"] for e in entries if not e["bits_equal"]]
    if bad:
        fail("demucs: %s differ from their plain versions at the cell's block" % bad)

    def entry(name, kind, source, what, launches_by_path):
        mine = [e for e in entries if e["kind"] == kind]
        return {"name": name, "route": "cuda", "source": source, "replaces": None,
                **{t: sum(e[t] for e in mine) for t in ("ms", "plain_ms", "bound_ms")},
                "library_ms": None,
                "bound_by": "the %d %s of a block at %d x 8 hops, each at its own"
                            % (len(mine), what, DEMUCS_B),
                "shape": [DEMUCS_B, 8], "products": mine,
                "launches_by_path": launches_by_path,
                "launches": sum(launches_by_path.values())}

    return (
        {"demucs_corpus_runner": runner_launches, "demucs_Koala.process": process_launches},
        entry("rowmm_fused", "fused", "koala_tpu_torch/csrc/rowmm.cu", "fused products",
              {"demucs_corpus_runner": fused, "demucs_Koala.process": process_fused}),
        entry("overlap_add", "overlap", "koala_tpu_torch/csrc/overlap.cu", "overlap passes",
              {"demucs_corpus_runner": tails, "demucs_Koala.process": process_tails}))


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
    from koala_tpu_torch.ops.kernels import _build, engine_fused, floor, gru, rowmm
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel
    from koala_tpu_torch.profiling import time_ms

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
                "engine_fused_device": (engine_fused, "device_launches"),
                "rowmm": (rowmm, "launches"),
                # the first design's kernel: launched by no path, only to hold the others
                "rowmm_simple": (rowmm, "simple_launches"),
                "mmse_gain": (mmse_kernel, "launches")}

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
    with Recorder(mask_gru_model, "gru_stack") as rec_step:
        for f in frames:
            s = time.perf_counter()
            out_proc.append(k.process(f.tolist()))
            lat.append(time.perf_counter() - s)
    proc_counts = counts()
    out_proc = np.asarray(out_proc, np.int16)
    if out_proc.shape != (PROCESS_FRAMES, 256):
        fail("process output shape %s" % (out_proc.shape,))
    print("path Koala.process: %d frames, launches %s" % (PROCESS_FRAMES, proc_counts))
    if proc_counts["gru_stack"] != PROCESS_FRAMES or proc_counts["rowmm"] < PROCESS_FRAMES:
        fail("Koala.process should launch the GRU kernel once a frame and rowmm: %s"
             % proc_counts)

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

    # Koala.enhance, one stream: floor + GRU kernels at a batch of one
    s = time.perf_counter()
    single_counts, floor_single, gru_single = single_stream_phase(kt, dev, card, reset_counts,
                                                                  counts, pcm)
    single_s = time.perf_counter() - s

    # Koala's acceptance gates on the held-out battery, four serving paths
    s = time.perf_counter()
    accept_counts, accept_held, accept_fused = acceptance_phase(kt, dev, card, reset_counts,
                                                                 counts)
    accept_s = time.perf_counter() - s

    # the rest of the public surface: mmse, identity, snapshots, the WebSocket front
    s = time.perf_counter()
    surface_counts, surface_held, surface_fused = surface_phase(kt, card, reset_counts, counts,
                                                                pcm)
    surface_s = time.perf_counter() - s

    # a stream's output against how it is cut into calls
    s = time.perf_counter()
    cuts_counts = cuts_phase(kt, card, reset_counts, counts, pcm)
    cuts_s = time.perf_counter() - s

    # KoalaBatch.process_chunk: floor + GRU kernels
    kb.process_chunk(pcm[:, :8 * 256])       # warm-up (lazy set-up)
    kb.reset()
    torch.cuda.synchronize()
    reset_counts()
    with Recorder(mask_gru_model, "floor_scan") as rec_floor, \
            Recorder(mask_gru_model, "gru_stack") as rec_gru, RecordAll(rowmm, "rowmm") as rec_mm:
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
    segments = fused_segments(rec_fused.args)
    if enh_counts["engine_fused"] != 1 or \
            enh_counts["engine_fused_device"] != len(engine_fused.STAGES) * segments:
        fail("enhance should make one fused call of %d segment(s), %d device launches a "
             "segment: %s" % (segments, len(engine_fused.STAGES), enh_counts))
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
    if chunk_counts["rowmm"] != len(ROWMM_SITES):
        fail("process_chunk should make %d rowmm launches: %s"
             % (len(ROWMM_SITES), chunk_counts))

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
    fl_bound = floor.bound(t_len, b, nb)
    kernels.append({
        "name": "floor_scan", "route": "cuda", "source": "koala_tpu_torch/csrc/floor.cu",
        "replaces": "koala_tpu/ops/pallas/floor.py:44", "launches": launches["floor_scan"],
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
    g_bound = gru.bound(t_len, b, h, L, hidden_out=False)
    library_gru = cudnn_gru_yardstick(xg, h0, training=False)
    with torch.inference_mode():
        lib_ms = time_ms(library_gru, 10)
    kernels.append({
        "name": "gru_stack", "route": "cuda", "source": "koala_tpu_torch/csrc/gru.cu",
        "replaces": "koala_tpu/ops/pallas/gru.py:104", "launches": launches["gru_stack"],
        "max_abs_err": max(gy_err, gh_err),
        "ms": time_ms(lambda: gru.gru_stack(h0, xg, wx, bx, wh, bh), 20, 2),
        "plain_ms": time_ms(lambda: gru.gru_stack_ref(h0, xg, wx, bx, wh, bh), 2, 1),
        "bound_ms": max(g_bound.values()), "bound_by": max(g_bound, key=g_bound.get),
        "library_ms": lib_ms, "shape": [t_len, b, h, L], **gru_launch_keys(gru, xg, L)})
    gru_shape_checks(gru, _build.library(), dev, (wx, bx, wh, bh))
    # and on the step's inputs (Koala.process: T = 1, a batch of one)
    kernels[1]["step"] = gru_step_hold(gru, rec_step.args, card)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], kernels[1]["step"]["max_abs_err"])

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
    b, t_len, _ = hops.shape
    h, L = cfg["hidden"], cfg["num_layers"]
    f_bound = engine_fused.bound(params, cfg, b, t_len)
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

    # the fixed-order product, on the inputs of process_chunk's nine products
    kernels.append(rowmm_hold(rowmm, rec_mm.calls, card))

    # ---- 4. the training path, its kernel variant and its gradients
    hs_entry, floor_train = training_phases(kt, dev, card, reset_counts, counts)
    kernels.insert(2, hs_entry)
    # the floor kernel runs on two paths: the entry's own numbers are those of
    # process_chunk's shape, the training path's stand beside them
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], floor_train["max_abs_err"])
    kernels[0]["train_path"] = floor_train
    # and one stream's Koala.enhance, at a batch of one, the floor and GRU kernels
    kernels[0]["single_stream"], kernels[1]["single_stream"] = floor_single, gru_single
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], gru_single["max_abs_err"])

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
    # ---- 6. the serving plane: StreamingServer backlog and live rounds, TCP front
    backlog_counts, backlog_held = serving_phases(dev, card, reset_counts, counts, pcm,
                                                  out_chunk, out_cpu)

    # ---- 7. the parallel layer: CorpusRunner and the data-parallel train step
    corpus_counts, dp_counts = parallel_phases(dev, card, reset_counts, counts, pcm)

    # ---- 8. bench_torch.py at its full batch
    phase_s = {}
    s = time.perf_counter()
    bench_counts, fused_at_bench, bench_held = bench_phase(dev, card, reset_counts, counts)
    next(kr for kr in kernels if kr["name"] == "engine_fused").update(fused_at_bench)
    phase_s["bench"] = time.perf_counter() - s

    # ---- 8b. bench_sweep_torch.py's component split, and pod_wash_torch.py
    s = time.perf_counter()
    sweep_counts, sweep_held = bench_sweep_phase(dev, card, reset_counts, counts)
    phase_s["bench_sweep"] = time.perf_counter() - s
    s = time.perf_counter()
    wash_counts, wash_held = pod_wash_phase(card, reset_counts, counts)
    phase_s["pod_wash"] = time.perf_counter() - s
    # the floor and GRU rows: the shapes at which each path's inputs were held
    # against the plain versions, and the GRU's largest error over them
    held = {"server_backlog": backlog_held, "bench": bench_held, "bench_sweep": sweep_held,
            "pod_wash": wash_held, **{"acceptance_" + p: h for p, h in accept_held.items()}}
    for held_at in held.values():
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], held_at["gru_max_abs_err"])
    for held_at in list(surface_held.values()):
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], held_at["gru_max_abs_err"])
    kernels[0]["held_on"] = dict({"process_chunk": kernels[0]["shape"],
                                  "Koala.enhance": floor_single["shape"],
                                  "train_on_device": floor_train["shape"]},
                                 **{p: h["floor_shape"] for p, h in held.items()},
                                 surface_snapshot={c: h["floor_shape"]
                                                   for c, h in surface_held.items()})
    kernels[1]["held_on"] = dict({"process_chunk": kernels[1]["shape"],
                                  "Koala.enhance": gru_single["shape"]},
                                 **{p: h["gru_shape"] for p, h in held.items()},
                                 surface_snapshot={c: h["gru_shape"]
                                                   for c, h in surface_held.items()})
    kernels[3]["max_abs_err"] = max([kernels[3]["max_abs_err"], accept_fused["max_abs_err"]]
                                    + [h["max_abs_err"] for h in surface_fused.values()])
    kernels[3]["held_on"] = {"enhance": kernels[3]["shape"],
                             "acceptance_enhance": accept_fused["shape"],
                             "surface_snapshot": {c: h["shape"]
                                                  for c, h in surface_fused.items()}}

    # ---- 9. the GRU kernel's gate: models with a launch plan, and one without
    s = time.perf_counter()
    gate_counts = gate_phase(kt, dev, card, reset_counts, counts)
    phase_s["gate"] = time.perf_counter() - s

    # ---- 10. the file demo on the card
    s = time.perf_counter()
    demo_phase(card)
    phase_s["demo"] = time.perf_counter() - s

    # ---- 11. the data generators, on a machine without JAX
    s = time.perf_counter()
    generators_phase(card)
    phase_s["generators"] = time.perf_counter() - s

    # ---- 12. FullSubNet and the LSTM-cell kernel
    s = time.perf_counter()
    lstm_entry = fullsubnet_phase(kt, dev, card)
    phase_s["fullsubnet"] = time.perf_counter() - s

    # ---- 12b. the mmse gain kernel at the corpus wash's shape
    s = time.perf_counter()
    mmse_entry = mmse_gain_phase(card, reset_counts, counts)
    phase_s["mmse_gain"] = time.perf_counter() - s
    mmse_entry["launches_by_path"].update(surface=surface_counts["mmse_gain"],
                                          cuts=cuts_counts["mmse_gain"])
    mmse_entry["launches"] = sum(mmse_entry["launches_by_path"].values())

    # ---- 12c. Demucs on the cell's path, its LSTM at depth 2048
    s = time.perf_counter()
    demucs_lstm, fused_entry, overlap_entry = demucs_phase(kt, card, reset_counts, counts)
    lstm_entry["launches_by_path"].update(demucs_lstm)
    phase_s["demucs"] = time.perf_counter() - s
    from koala_tpu_torch.ops.kernels import lstm
    lstm_entry["launches"] = lstm.launches

    # every kernel's launches, by the path that made them
    by_path = {
        "floor_scan": {"process_chunk": launches["floor_scan"],
                       "Koala.enhance": single_counts["floor_scan"],
                       "train_on_device": floor_train["launches"],
                       "server_backlog": backlog_counts["floor_scan"],
                       "data_parallel_step": dp_counts["floor_scan"],
                       "bench": bench_counts["floor_scan"],
                       "bench_sweep": sweep_counts["floor_scan"],
                       "pod_wash": wash_counts["floor_scan"],
                       "gate_phase": gate_counts["floor_scan"],
                       "acceptance": accept_counts["floor_scan"],
                       "surface": surface_counts["floor_scan"]},
        "gru_stack": {"process_chunk": launches["gru_stack"],
                      "Koala.enhance": single_counts["gru_stack"],
                      "server_backlog": backlog_counts["gru_stack"],
                      "bench": bench_counts["gru_stack"],
                      "bench_sweep": sweep_counts["gru_stack"],
                      "pod_wash": wash_counts["gru_stack"],
                      "gate_phase": gate_counts["gru_stack"],
                      "acceptance": accept_counts["gru_stack"],
                      "surface": surface_counts["gru_stack"]},
        "gru_stack_hs": {"train_on_device": hs_entry["launches"],
                         "data_parallel_step": dp_counts["gru_stack_hs"],
                         "gate_phase": gate_counts["gru_stack_hs"],
                         "acceptance": accept_counts["gru_stack_hs"],
                         "surface": surface_counts["gru_stack_hs"]},
        "engine_fused": {"enhance": launches["engine_fused"],
                         "corpus_runner": corpus_counts["engine_fused"],
                         "bench": bench_counts["engine_fused"],
                         "bench_sweep": sweep_counts["engine_fused"],
                         "pod_wash": wash_counts["engine_fused"],
                         "gate_phase": gate_counts["engine_fused"],
                         "acceptance": accept_counts["engine_fused"],
                         "surface": surface_counts["engine_fused"]},
        "rowmm": {"Koala.process": proc_counts["rowmm"],
                  "process_chunk": chunk_counts["rowmm"],
                  "enhance": enh_counts["rowmm"],
                  "Koala.enhance": single_counts["rowmm"],
                  "server_backlog": backlog_counts["rowmm"],
                  "corpus_runner": corpus_counts["rowmm"],
                  "data_parallel_step": dp_counts["rowmm"],
                  "bench": bench_counts["rowmm"],
                  "bench_sweep": sweep_counts["rowmm"],
                  "pod_wash": wash_counts["rowmm"],
                  "gate_phase": gate_counts["rowmm"],
                  "acceptance": accept_counts["rowmm"],
                  "surface": surface_counts["rowmm"],
                  "cuts": cuts_counts["rowmm"]},
    }
    for kr in kernels:
        kr["launches_by_path"] = by_path[kr["name"]]
        kr["launches"] = sum(by_path[kr["name"]].values())

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
                            kr["empty_launch_queued_ms"]) if "queued_ms" in kr else
                         " (the nine products of process_chunk)",
                         kr["launches"], card))
    print("kernel floor_scan on the training path, lb %s: ms %.4f queued_ms %.4f plain_ms %.4f "
          "max|err| %g launches %d on %s"
          % (floor_train["shape"], floor_train["ms"], floor_train["queued_ms"],
             floor_train["plain_ms"], floor_train["max_abs_err"], floor_train["launches"], card))
    k.delete()
    kb.delete()
    print("chip_smoke: %.1f s from the build on, of which one stream's enhance %.1f s, "
          "acceptance %.1f s, surface %.1f s, cuts %.1f s, bench %.1f s, bench_sweep %.1f s, "
          "pod_wash %.1f s, gate %.1f s, demo %.1f s, generators %.1f s, fullsubnet %.1f s, "
          "mmse_gain %.1f s, demucs %.1f s"
          % (time.perf_counter() - t0, single_s, accept_s, surface_s, cuts_s, phase_s["bench"],
             phase_s["bench_sweep"], phase_s["pod_wash"], phase_s["gate"], phase_s["demo"],
             phase_s["generators"], phase_s["fullsubnet"], phase_s["mmse_gain"],
             phase_s["demucs"]))

    for kr in (fused_entry, overlap_entry):
        print("kernel %-13s ms %.4f plain_ms %.4f bound_ms %.4f (%s) launches %s on %s"
              % (kr["name"], kr["ms"], kr["plain_ms"], kr["bound_ms"], kr["bound_by"],
                 kr["launches_by_path"], card))
    kernels += [lstm_entry, mmse_entry, fused_entry, overlap_entry]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
