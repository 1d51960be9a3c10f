"""Corpus wash: `CorpusRunner.enhance_batch` back to back on float32 batches.

Traffic parameters (`traffic/<mix>.json`): `global_batch` utterances of
`utterance_seconds` a batch; `distinct_batches` different batches built at
set-up from the seed and fed in turn (a corpus reader's host arrays);
`sample` output rows compared; SNR and level ranges of the mixes;
`host_memory`, where the reader keeps its batches: `pageable` (numpy's
own, the default) or `pinned` (page-locked, as a PyTorch loader with
`pin_memory=True` hands them over); `trace_seconds` of the window traced
in a traced run.

The window issues batches while it runs (the host returns once a batch's
upload has been made and its kernels queued), then waits for the card; its
rate is the audio of every batch issued over the whole time, to the end of
the last batch.

The sample is a reservoir over every row of every batch the window issued,
drawn from the seed: a row that enters it is copied, behind the batch's
kernels, into page-locked host memory set aside at set-up. So the harness
holds nothing on the card and launches no kernel in the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import audio
from benchmark.tracing import synchronize
from koala_tpu_torch.ops.kernels.engine_fused import T_BLOCK
from koala_tpu_torch.parallel.mesh import make_mesh
from koala_tpu_torch.parallel.runner import CorpusRunner

HOP = 256
RATE = 16000
MAX_BATCHES = 100000


class Driver:
    def __init__(self, run):
        tr = run.traffic
        self.run = run
        self.batch = int(tr["global_batch"])
        self.samples = int(round(tr["utterance_seconds"] * RATE)) // HOP * HOP
        self.hops = self.samples // HOP
        self.issued = 0
        run.batch_rows, run.hops = self.batch, self.hops

    def setup(self) -> None:
        run, tr = self.run, self.run.traffic
        dev = run.device
        self.runner = CorpusRunner(run.model_path, self.batch, self.samples, mesh=make_mesh([dev]))
        bank = audio.Bank(run.root, dev)
        pinned = tr.get("host_memory", "pageable") == "pinned" and dev.type == "cuda"
        self.batches = []
        for _ in range(int(tr["distinct_batches"])):
            plan = audio.Plan(run.rng, self.batch, bank.length, tr["snr_db"], tr["level_db"])
            host = torch.empty((self.batch, self.samples), dtype=torch.float32, pin_memory=pinned)
            host.copy_(audio.mix_blocks(bank, plan, self.samples))
            self.batches.append(host.numpy())   # a reader's numpy batch
        del bank
        n = int(tr["sample"])
        self.slots = torch.empty((n, self.hops, HOP), dtype=torch.float32,
                                 pin_memory=dev.type == "cuda")
        self.held = {}                      # slot -> (batch, row) in it
        # the fused entry takes the whole multiples of T_BLOCK hops, the rest
        # the engine's sequence path (`Engine.sequence_fast`)
        fused = "fused_spectral" in run.config["precision"] and dev.type == "cuda"
        self.fused_hops = run.fused_hops = self.hops // T_BLOCK * T_BLOCK if fused else 0
        for i in range(2):
            out = self.runner.enhance_batch(self.batches[i % len(self.batches)])
            self.slots[0].copy_(out[0], non_blocking=True)
        synchronize(dev)

    def counters(self):
        return {"batches": self.issued, "audio_s": self.audio_seconds(self.issued)}

    def draws(self, i: int):
        """Reservoir sampling over the rows of batch `i`: -> {slot: row}, the
        last row drawn into each slot."""
        n = self.slots.shape[0]
        seen = i * self.batch + np.arange(self.batch)
        slot = np.where(seen < n, seen, self.run.rng.integers(0, seen + 1))
        rows = np.flatnonzero(slot < n)
        return dict(zip(slot[rows].tolist(), rows.tolist()))

    def drive(self, window) -> None:
        while window.running() and self.issued < MAX_BATCHES:
            k = self.issued % len(self.batches)
            with window.span("enhance_batch"):
                out = self.runner.enhance_batch(self.batches[k])
            for s, r in self.draws(self.issued).items():
                self.slots[s].copy_(out[r], non_blocking=True)
                self.held[s] = (k, r)
            self.issued += 1

    def audio_seconds(self, batches) -> float:
        return batches * self.batch * self.samples / RATE

    def end_to_end(self, window):
        return {"batch_audio_s_per_s": self.audio_seconds(self.issued) / window.elapsed}

    def attempted_failed(self):
        return self.issued * self.batch, 0

    def collect(self):
        """The reservoir's rows, with their inputs (the card has finished:
        the window closes with a synchronisation)."""
        return [{"hops": self.batches[k][r].reshape(self.hops, HOP),
                 "out": self.slots[s].numpy().copy(), "fused_hops": self.fused_hops}
                for s, (k, r) in sorted(self.held.items())]

    def close(self) -> None:
        self.slots = None
        self.runner = None
