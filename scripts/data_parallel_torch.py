"""The port's parallel layer over several processes, one device each.

    python3 scripts/data_parallel_torch.py [--procs 4] [--device gpu|cpu] [--steps 8]

Starts ``--procs`` processes (``torch.multiprocessing``, spawn), each with a
process group over ``tcp://127.0.0.1:<free port>`` (NCCL on cards, gloo on
the CPU) and a mesh of its own device (``gpu:<rank>`` or ``cpu``). Each
process then:

1. trains ``TRAIN_CONFIG`` with ``make_train_step(mesh=...)`` for ``--steps``
   steps on its slice of a global batch of ``--batch`` x 63 frames drawn
   from the same seed on every process, and checks that the weights are
   bit-identical across the processes after every step;
2. washes ``--batches`` global batches of ``--batch`` x 6.0 s utterances with
   ``CorpusRunner`` (the fused engine on a card), whose report sums the audio
   seconds over the processes.

Rank 0 prints the step time (median over the steps after the first two),
the wash's audio-s/s, and the device with the card's name and power limit.
"""

import argparse
import os
import socket
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _weights_digest(params) -> torch.Tensor:
    """Sum and sum of squares of every weight in float64: equal across the
    processes only if the weights are (up to a collision no step produces)."""
    flat = torch.cat([p.detach().reshape(-1).double() for p in params.parameters()])
    return torch.stack([flat.sum(), (flat * flat).sum(), flat.abs().max()])


def worker(rank, world, port, args):
    import importlib

    import torch.distributed as dist

    from koala_tpu_torch.models import mask_gru
    from koala_tpu_torch.models.params_io import default_model_path
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh
    from koala_tpu_torch.train.data import MixtureSampler

    trainer = importlib.import_module("koala_tpu_torch.train.train")
    card = args.device == "gpu"
    if card:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if card else "gloo",
                            init_method="tcp://127.0.0.1:%d" % port, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(["gpu:%d" % rank if card else "cpu"])
        dev = mesh.devices[0]
        cfg = dict(mask_gru.TRAIN_CONFIG)
        rng = np.random.default_rng(0)
        t = np.arange(16000 * 8) / 16000.0
        speech = [(np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 3 * t) * 0.3
                   ).astype(np.float32)]
        noise = [(rng.standard_normal(len(t)) * 0.05).astype(np.float32)]
        sampler = MixtureSampler(speech, noise, segment_frames=63, seed=1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = mask_gru.init_params(gen, cfg).requires_grad_(True)
        step = trainer.make_train_step(cfg, trainer.make_optimizer(params, 3e-4, 1000),
                                       mesh=mesh)
        ms, losses = [], []
        for i in range(args.steps):
            noisy, clean = sampler.sample(args.batch)
            if card:
                torch.cuda.synchronize(dev)
            s = time.perf_counter()
            loss = step(params, torch.as_tensor(noisy), torch.as_tensor(clean))
            if card:
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - s) * 1e3)
            losses.append(float(loss))
            digest = _weights_digest(params)
            low, high = digest.clone(), digest.clone()
            dist.all_reduce(low, op=dist.ReduceOp.MIN)
            dist.all_reduce(high, op=dist.ReduceOp.MAX)
            if not torch.equal(low, high):
                raise RuntimeError("step %d: the weights differ across the processes" % i)

        samples = 376 * 256
        runner = CorpusRunner(default_model_path(), global_batch=args.batch,
                              utterance_samples=samples, mesh=mesh)
        pcm = (rng.standard_normal((args.batch, samples)) * 0.1).astype(np.float32)
        report = runner.wash([pcm] * (args.batches + 1), warmup=1)
        if rank == 0:
            what = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True,
                                   text=True, timeout=60).stdout.strip().splitlines()[0]
                    if card else "CPU (no card number)")
            tail = ms[2:] or ms
            print("data-parallel step, %d processes, global B=%d x 63 (%d a process): "
                  "loss %.4f -> %.4f, weights bit-identical across processes after each "
                  "of %d steps; %.2f ms a step (median of %d, %.2f-%.2f) on %s"
                  % (world, args.batch, args.batch // world, losses[0], losses[-1],
                     args.steps, statistics.median(tail), len(tail), min(tail), max(tail),
                     what), flush=True)
            print("CorpusRunner wash, %d processes, global B=%d x 6.0 s, %d batches: "
                  "%.1f audio-s/s (%.1f a device), %.3f s wall, audio %.1f s summed over "
                  "the processes on %s"
                  % (world, args.batch, report["batches"], report["audio_seconds_per_second"],
                     report["audio_seconds_per_second_per_chip"], report["wall_seconds"],
                     report["audio_seconds"], what), flush=True)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=64, help="global batch")
    ap.add_argument("--batches", type=int, default=5, help="wash batches after one warm-up")
    args = ap.parse_args()
    if args.device == "gpu" and torch.cuda.device_count() < args.procs:
        sys.exit("%d processes need %d cards, %d present"
                 % (args.procs, args.procs, torch.cuda.device_count()))
    import torch.multiprocessing as mp

    mp.start_processes(worker, args=(args.procs, _free_port(), args), nprocs=args.procs,
                       join=True, start_method="spawn")


if __name__ == "__main__":
    main()
