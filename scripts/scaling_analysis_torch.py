"""Scaling analysis of the PyTorch/CUDA port's data-parallel wash and train step.

    python3 scripts/scaling_analysis_torch.py [--procs 2] [--out-dir DIR]
        [--batch 64] [--frames 188] [--iters 6] [--shards 1,2,4,8]

The port's counterpart of ``scripts/scaling_analysis.py``. It writes
``scaling_analysis_torch.json`` and ``SCALING_torch.md`` under ``--out-dir``
(default ``resources/reports/``) with:

1. A census of the collectives that ran, counted, not read off a program:
   ``--procs`` processes (``torch.multiprocessing``, spawn) join a gloo
   group over ``tcp://127.0.0.1:<free port>``, each with a mesh of one
   device (``make_train_step(mesh=...)`` takes one a process), and every
   ``torch.distributed`` collective is wrapped to count its calls and bytes.
   Counted apart: one ``CorpusRunner`` batch (expected: no collective), a
   ``wash`` (expected: one ``all_reduce`` of the report's audio seconds) and
   one data-parallel train step of ``TRAIN_CONFIG`` (expected: one
   ``all_reduce`` of the flattened gradients and the loss).
2. A retention sweep: ``CorpusRunner.wash`` at a fixed global batch over
   meshes of 1, 2, 4, 8 CPU shards in one process. The shards share the
   host's cores, so only the aggregate throughput against one shard's (the
   retention) says anything: the cost of splitting and issuing the batch.
3. The expectation for cards that these two support.

It runs on the CPU by design, as the reference does: which collectives the
code issues does not depend on the device, and the sweep's shards are CPU
shards. The card's own numbers come from ``scripts/pod_wash_torch.py
--efficiency`` and ``scripts/data_parallel_torch.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPORTS = os.path.join(REPO, "resources", "reports")
# torch.distributed's collectives, each wrapped to count its calls and bytes
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter",
               "all_to_all", "all_to_all_single", "barrier")
TRAIN_FRAMES = 16          # frames a segment of the census's train step


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class CollectiveCounter:
    """Wraps every collective of ``torch.distributed`` while installed;
    ``take()`` returns {name: {"calls", "bytes"}} since the last take."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.orig, self.seen = dist, {}, {}

    def _wrap(self, name, fn):
        def counted(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            tensors += [t for a in args if isinstance(a, (list, tuple))
                        for t in a if isinstance(t, torch.Tensor)]
            row = self.seen.setdefault(name, {"calls": 0, "bytes": 0})
            row["calls"] += 1
            row["bytes"] += sum(t.numel() * t.element_size() for t in tensors[:1])
            return fn(*args, **kwargs)
        return counted

    def __enter__(self):
        for name in COLLECTIVES:
            if hasattr(self.dist, name):
                self.orig[name] = getattr(self.dist, name)
                setattr(self.dist, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)

    def take(self):
        seen, self.seen = self.seen, {}
        return seen


def census_worker(rank, world, port, out_path, batch):
    """One process of the census: a wash batch, a wash, a train step."""
    import importlib

    import torch.distributed as dist

    from koala_tpu_torch.constants import FRAME_LENGTH
    from koala_tpu_torch.models import mask_gru
    from koala_tpu_torch.models.params_io import default_model_path
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    trainer = importlib.import_module("koala_tpu_torch.train.train")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(["cpu"])
        rng = np.random.default_rng(0)
        samples = TRAIN_FRAMES * FRAME_LENGTH
        pcm = (rng.standard_normal((batch, samples)) * 0.05).astype(np.float32)
        runner = CorpusRunner(default_model_path(), batch, samples, mesh)
        cfg = dict(mask_gru.TRAIN_CONFIG)
        gen = torch.Generator().manual_seed(0)
        params = mask_gru.init_params(gen, cfg).requires_grad_(True)
        step = trainer.make_train_step(cfg, trainer.make_optimizer(params, 3e-4, 100), mesh=mesh)
        noisy = torch.as_tensor(pcm)
        with CollectiveCounter() as counter:
            runner.enhance_batch(pcm)
            wash_batch = counter.take()
            runner.wash([pcm] * 3, warmup=1)
            wash = counter.take()
            step(params, noisy, noisy)
            train_step = counter.take()
        n_params = sum(p.numel() for p in params.parameters())
        if rank == 0:
            with open(out_path, "w") as fh:
                json.dump({"processes": world, "backend": "gloo", "global_batch": batch,
                           "wash_batch": wash_batch, "wash": wash, "train_step": train_step,
                           "train_params": n_params,
                           "gradient_bytes_expected": (n_params + 1) * 4}, fh)
    finally:
        dist.destroy_process_group()


def collective_census(procs: int, batch: int) -> dict:
    """Section 1: the collectives counted in ``procs`` gloo processes."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "census.json")
        mp.start_processes(census_worker, args=(procs, _free_port(), out, batch), nprocs=procs,
                           join=True, start_method="spawn")
        with open(out) as fh:
            return json.load(fh)


def retention_sweep(shards, batch: int, frames: int, iters: int) -> dict:
    """Section 2: a wash at a fixed global batch over meshes of CPU shards."""
    from koala_tpu_torch.constants import FRAME_LENGTH, SAMPLE_RATE
    from koala_tpu_torch.models.params_io import default_model_path
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    samples = frames * FRAME_LENGTH
    pcm = np.zeros((batch, samples), np.float32)
    rows = []
    for n in shards:
        runner = CorpusRunner(default_model_path(), batch, samples, make_mesh(["cpu"] * n))
        report = runner.wash([pcm] * (iters + 1), warmup=1)
        rows.append({"devices": n, "audio_s_per_s": report["audio_seconds_per_second"]})
        print("devices=%d  %.1f audio-s/s" % (n, rows[-1]["audio_s_per_s"]), flush=True)
    for row in rows:
        row["aggregate_retention"] = row["audio_s_per_s"] / rows[0]["audio_s_per_s"]
    return {"global_batch": batch, "frames": frames, "iters": iters,
            "audio_seconds_a_batch": batch * samples / SAMPLE_RATE,
            "note": ("N CPU shards share one host's cores and run one after another: "
                     "aggregate throughput against one shard's measures the cost of "
                     "splitting and issuing the batch; per-device division by N means "
                     "nothing here."),
            "rows": rows}


def _calls(rows) -> str:
    return ", ".join("%s x %d (%d bytes)" % (k, v["calls"], v["bytes"])
                     for k, v in sorted(rows.items())) or "none"


def write_markdown(path: str, report: dict) -> None:
    c, s = report["collective_census"], report["retention_sweep"]
    last = s["rows"][-1]
    table = "\n".join("| %d | %.1f | %.1f%% |" % (r["devices"], r["audio_s_per_s"],
                                                   100 * r["aggregate_retention"])
                      for r in s["rows"])
    md = f"""# Scaling analysis of the PyTorch/CUDA port (CPU processes and shards)

Written by `scripts/scaling_analysis_torch.py`. Every number below is from
the CPU; none is a card's.

## 1. Collectives that ran ({c['processes']} gloo processes, one device each)

- **One `CorpusRunner` batch** (global batch {c['global_batch']}): {_calls(c['wash_batch'])}.
  Each process enhances its own rows of the batch and never communicates.
- **A `wash` of two counted batches**: {_calls(c['wash'])}: the report's sum of
  the audio seconds, once a wash, not once a batch.
- **One data-parallel train step** (`make_train_step(mesh=...)`,
  `TRAIN_CONFIG`, {c['train_params']} weights): {_calls(c['train_step'])}; the
  flattened gradients and the loss are {c['gradient_bytes_expected']} bytes.

## 2. Retention sweep (global batch {s['global_batch']}, T = {s['frames']}, {s['iters']} batches a mesh)

| CPU shards | audio-s/s | aggregate retention |
|---|---|---|
{table}

{s['note']} At {last['devices']} shards {100 * last['aggregate_retention']:.0f}% of one
shard's throughput remains.

## 3. Expectation for cards (not measured)

A wash issues no collective on its hot path, so N cards each running
`sequence_fast` on their own rows should scale with N up to what the host
that feeds them can do: the expectation is a per-card throughput near one
card's (`scripts/pod_wash_torch.py --efficiency`), bounded by the host
that converts and uploads each batch from pageable memory (`ROADMAP.md`,
speed item 1). The train step adds one all-reduce of
{c['gradient_bytes_expected']} bytes a step; over NVLink between H100s that is
a small share of a step of tens of milliseconds. Neither has run on four
cards yet.
"""
    with open(path, "w") as fh:
        fh.write(md)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--out-dir", default=REPORTS)
    ap.add_argument("--batch", type=int, default=64, help="the sweep's global batch")
    ap.add_argument("--frames", type=int, default=188)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--shards", default="1,2,4,8")
    args = ap.parse_args(argv)
    start = time.perf_counter()
    report = {"collective_census": collective_census(args.procs, 2 * args.procs)}
    print(json.dumps(report["collective_census"]), flush=True)
    report["retention_sweep"] = retention_sweep([int(v) for v in args.shards.split(",")],
                                                args.batch, args.frames, args.iters)
    report["seconds"] = time.perf_counter() - start
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "scaling_analysis_torch.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    write_markdown(os.path.join(args.out_dir, "SCALING_torch.md"), report)
    print("wrote", os.path.join(args.out_dir, "SCALING_torch.md"))
    return report


if __name__ == "__main__":
    main()
