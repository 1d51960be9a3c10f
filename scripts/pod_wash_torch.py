"""Corpus wash of the PyTorch/CUDA port: enhance a noisy corpus
utterance-parallel over every card of every process, and report throughput
and scaling efficiency.

    python3 scripts/pod_wash_torch.py --utterances 1024
    KOALA_POD_CPU_DEVICES=4 python3 scripts/pod_wash_torch.py --utterances 16 \
        --utterance-seconds 0.5 --efficiency           # CPU smoke, four shards
    torchrun --nproc-per-node 4 scripts/pod_wash_torch.py ...    # several processes

The port's counterpart of ``scripts/pod_wash.py``, with its flags, its seeded
corpus (white speech stand-in plus ``train/data.py`` pink noise at
``--snr-db``) and its report lines: the host's ``machine_state``, one
``CorpusRunner.wash`` report a mesh, and with ``--efficiency`` on more than
one device the ``scaling_efficiency`` record (audio-s/s per device at N
devices over one device's, and the aggregate retention on the same host).

The mesh is ``make_mesh()``: every card of this process.
``KOALA_POD_CPU_DEVICES=N`` makes it N CPU shards instead
(``virtual_cpu_mesh``: they share the host's cores). Several processes: with
``WORLD_SIZE`` > 1 in the environment (``torchrun`` sets it, with ``RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) the script initialises
``torch.distributed`` from it, NCCL on cards and gloo on the CPU, and each
process takes one card, ``LOCAL_RANK``. Without a card and without
``KOALA_POD_CPU_DEVICES`` it stops with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from koala_tpu_torch.constants import FRAME_LENGTH, SAMPLE_RATE  # noqa: E402
from koala_tpu_torch.models.params_io import default_model_path  # noqa: E402
from koala_tpu_torch.parallel import CorpusRunner, make_mesh  # noqa: E402
from koala_tpu_torch.profiling import machine_state  # noqa: E402
from koala_tpu_torch.train.data import synth_noise  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utterances", type=int, default=512)
    ap.add_argument("--utterance-seconds", type=float, default=4.0)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: all devices x 64)")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--efficiency", action="store_true",
                    help="also run on one device to compute scaling efficiency")
    ap.add_argument("--snr-db", type=float, default=5.0)
    return ap.parse_args(argv)


def _init_distributed(n_cpu) -> None:
    """Join the process group that the standard environment describes."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    if n_cpu:
        dist.init_process_group("gloo")
        return
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl")


def _devices(n_cpu):
    """This process's devices: N CPU shards, this rank's card, or every card."""
    if n_cpu:
        return ["cpu"] * int(n_cpu)
    if dist.is_initialized():
        return ["gpu:%d" % torch.cuda.current_device()]
    return None


def main(argv=None) -> list:
    """Runs the wash; returns the JSON records it printed."""
    args = parse_args(argv)
    n_cpu = os.environ.get("KOALA_POD_CPU_DEVICES")
    _init_distributed(n_cpu)
    model_path = args.model_path or default_model_path()
    samples = int(args.utterance_seconds * SAMPLE_RATE)
    samples = (samples // FRAME_LENGTH) * FRAME_LENGTH
    rng = np.random.default_rng(0)
    records = []

    def emit(record):
        records.append(record)
        print(json.dumps(record), flush=True)

    print("machine state:", json.dumps(machine_state()), flush=True)

    def run_on(mesh, tag):
        n_dev = mesh.size
        batch = args.batch or n_dev * 64
        # keep at least 2 batches so the warm-up batch takes the one-off set-up
        batch = min(batch, (args.utterances // (2 * n_dev)) * n_dev) or n_dev
        runner = CorpusRunner(model_path, batch, samples, mesh)

        def batches():
            total = (args.utterances // batch) * batch
            for _ in range(0, total, batch):
                speech = rng.standard_normal((batch, samples)).astype(np.float32) * 0.05
                noise = np.repeat(synth_noise(rng, samples, "pink")[None], batch, axis=0)
                noise = noise.astype(np.float32)
                yield speech + noise * 0.05 * 10 ** (-args.snr_db / 20.0)

        n_batches = args.utterances // batch
        report = runner.wash(batches(), warmup=1 if n_batches > 1 else 0)
        report["tag"] = tag
        emit(report)
        return report

    full_mesh = make_mesh(_devices(n_cpu))
    report = run_on(full_mesh, "all-devices")
    if args.efficiency and full_mesh.size > 1:
        single = run_on(make_mesh(full_mesh.devices[:1]), "one-device")
        # per-device throughput at N devices over one device's: the number for
        # distinct cards; the aggregate retention is the honest one for CPU
        # shards, which share the host's cores
        eff = (report["audio_seconds_per_second_per_chip"]
               / max(single["audio_seconds_per_second_per_chip"], 1e-9))
        retention = (report["audio_seconds_per_second"]
                     / max(single["audio_seconds_per_second"], 1e-9))
        emit({"metric": "scaling_efficiency", "chips": int(full_mesh.size),
              "value": round(eff, 4), "aggregate_retention": round(retention, 4),
              "virtual_cpu_mesh": bool(n_cpu)})
    return records


if __name__ == "__main__":
    main()
