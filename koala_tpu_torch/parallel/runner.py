"""Corpus runner: utterance-parallel enhancement over a mesh.

The port of the JAX package's ``parallel/runner.py`` ("pod-scale corpus
wash"): a noisy corpus split utterance-parallel over every device of every
process, the model replicated, with a throughput report. Each device takes
its block of the global batch and runs ``Engine.sequence_fast`` (the fused
engine kernels on a card); every device's work is issued before any is
waited on, and no kernel wrapper on that path waits for the card, so the
cards run side by side. The only collective is the sum of the audio seconds
in the report, through ``torch.distributed.all_reduce`` when the mesh has a
process group.

For a run over several processes, initialise ``torch.distributed`` first and
give each process its own card (``make_mesh(["gpu:%d" % rank])``); each
process feeds its slice of every global batch.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..constants import FRAME_LENGTH, SAMPLE_RATE
from ..device import device_scope
from ..engine.core import make_engine
from ..models import params_io
from .mesh import Mesh, make_mesh, replicate, shard_batch


def _synchronize(mesh: Mesh) -> None:
    for d in mesh.devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class CorpusRunner:
    """Enhances fixed-size batches of equal-length utterances over a mesh."""

    def __init__(
            self,
            model_path: str,
            global_batch: int,
            utterance_samples: int,
            mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.size
        if global_batch % n_dev != 0:
            raise ValueError("global_batch %d must divide by mesh size %d"
                             % (global_batch, n_dev))
        if utterance_samples % FRAME_LENGTH != 0:
            raise ValueError("utterance_samples must be a multiple of %d" % FRAME_LENGTH)

        self.global_batch = global_batch
        self.utterance_samples = utterance_samples
        self.frames = utterance_samples // FRAME_LENGTH
        lo, hi = self.mesh.local_rows(global_batch)
        self.local_batch = hi - lo

        tree, config = params_io.load_params(model_path)
        kind = config.get("kind", "mask_gru")
        self.engine = make_engine(kind, config)
        self.params = replicate(self.mesh, params_io.params_from_numpy(tree, "cpu", kind))

    @torch.inference_mode()
    def _issue(self, pcm) -> List[torch.Tensor]:
        """Issue every device's block; -> one [B/n, T, 256] output a device."""
        pcm = np.asarray(pcm, np.float32)
        hops = pcm.reshape(self.global_batch, self.frames, FRAME_LENGTH)
        outs = []
        for d, p, block in zip(self.mesh.devices, self.params, shard_batch(self.mesh, hops)):
            with device_scope(d):
                state = self.engine.init_state((block.shape[0],), d)
                _, out = self.engine.sequence_fast(p, state, block)
            outs.append(out)
        return outs

    def enhance_batch(self, pcm) -> torch.Tensor:
        """[B, N] float32 (fullscale 1.0) -> this process's rows of the
        enhanced batch, [B_local, T, 256], on the mesh's first device."""
        outs = self._issue(pcm)
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.mesh.devices[0]) for o in outs])

    def wash(self, batches: Iterable[np.ndarray], warmup: int = 1) -> Dict[str, Any]:
        """Run the corpus; returns a throughput report. The first ``warmup``
        batches are run and not counted."""
        audio_seconds = 0.0
        n_batches = 0
        start = time.perf_counter() if warmup == 0 else None
        for i, pcm in enumerate(batches):
            self._issue(pcm)
            if i + 1 == warmup:
                _synchronize(self.mesh)
                start = time.perf_counter()
                continue
            if i >= warmup:
                audio_seconds += self.local_batch * self.utterance_samples / SAMPLE_RATE
                n_batches += 1
        _synchronize(self.mesh)
        elapsed = (time.perf_counter() - start) if start is not None else 0.0
        if self.mesh.group is not None:
            # on the mesh's device: an NCCL group reduces only card tensors
            total = torch.tensor([audio_seconds], dtype=torch.float64,
                                 device=self.mesh.devices[0])
            dist.all_reduce(total, group=self.mesh.group)
            audio_seconds = float(total[0])
        n_chips = self.mesh.size
        throughput = audio_seconds / elapsed if elapsed > 0 else float("nan")
        return {
            "batches": n_batches,
            "audio_seconds": audio_seconds,
            "wall_seconds": elapsed,
            "chips": n_chips,
            "audio_seconds_per_second": throughput,
            "audio_seconds_per_second_per_chip": throughput / max(n_chips, 1),
            "rtf_aggregate": throughput,
        }


def wash_corpus(
        model_path: str,
        utterances: np.ndarray,
        mesh: Optional[Mesh] = None,
        batch: Optional[int] = None) -> Dict[str, Any]:
    """Convenience wrapper: [N, samples] int16/float corpus -> report."""
    utterances = np.asarray(utterances)
    n, samples = utterances.shape
    mesh = mesh if mesh is not None else make_mesh()
    batch = batch or mesh.size * max(1, n // mesh.size)
    batch = min(batch, (n // mesh.size) * mesh.size)
    samples = (samples // FRAME_LENGTH) * FRAME_LENGTH

    runner = CorpusRunner(model_path, batch, samples, mesh)
    if utterances.dtype == np.int16:
        corpus = utterances[:, :samples].astype(np.float32) / 32768.0
    else:
        corpus = utterances[:, :samples].astype(np.float32)

    def batches():
        for i in range(0, (n // batch) * batch, batch):
            yield corpus[i:i + batch]

    return runner.wash(batches(), warmup=0)


__all__ = ["CorpusRunner", "wash_corpus"]
