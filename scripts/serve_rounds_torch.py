"""Host time of one single-frame serving round on a CUDA card, eager and as
a CUDA-graph replay, alone and beside a polling client thread.

    python3 scripts/serve_rounds_torch.py [--streams 64] [--rounds 300]

A round is what StreamingServer's dispatch thread does for one frame of
every stream: upload the int16 hops through pinned memory, the masked step
(``Engine.step_masked``) with the state committed in place, int16 out, copy
to pinned host memory, record an event. "eager" issues the step's launches
one by one; "graph" replays the server's captured step (``_StepGraph``).
The time is wall clock over ``--rounds`` rounds issued back to back, then
one synchronise, so it is the host's cost of issuing a round whenever that
exceeds the card's. "beside a client": another thread wakes every 0.2 ms,
runs a little Python and sleeps, as a client polling for output does.
Prints one line per case with the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_rounds_torch.py measures on a CUDA card; none is present")

    from koala_tpu_torch.engine.stream import load_model
    from koala_tpu_torch.models.params_io import default_model_path
    from koala_tpu_torch.serve import _assign, _Shard, _StepGraph, _to_pcm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    n = args.streams
    engine, params = load_model(default_model_path(), dev)
    shard = _Shard(dev, 0, n, params, engine.init_state((n,), dev))
    rng = np.random.default_rng(0)
    hops = (rng.standard_normal((args.rounds, n, 256)) * 3000).astype(np.int16)
    active = np.ones(n, bool)

    def upload(a):
        staged = torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, pin_memory=True)
        staged.copy_(torch.from_numpy(a))
        return staged.to(dev, non_blocking=True)

    def download(pcm):
        host = torch.empty(pcm.shape, dtype=torch.int16, pin_memory=True)
        host.copy_(pcm, non_blocking=True)
        torch.cuda.Event().record()
        return host

    def eager(i):
        new_state, out = engine.step_masked(params, shard.state,
                                            upload(hops[i]).to(torch.float32) / 32768.0,
                                            upload(active))
        _assign(shard.state, new_state)
        return download(_to_pcm(out))

    with torch.inference_mode():
        graph = _StepGraph(engine, shard)

        def graphed(i):
            return download(graph.replay(upload(hops[i]), upload(active)).clone())

        stop = threading.Event()

        def client():
            x = np.zeros(64)
            while not stop.is_set():
                x += 1.0
                _ = [v for v in x[:16]]
                time.sleep(0.0002)

        for beside in (False, True):
            th = None
            if beside:
                th = threading.Thread(target=client, daemon=True)
                th.start()
            for name, fn in (("eager", eager), ("graph", graphed), ("eager", eager)):
                for i in range(10):
                    fn(i)
                torch.cuda.synchronize()
                s = time.perf_counter()
                for i in range(args.rounds):
                    fn(i)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - s) / args.rounds * 1e3
                print("round %-5s B=%d %s: %.3f ms a round (%d rounds) on %s"
                      % (name, n, "beside a client" if beside else "alone", ms,
                         args.rounds, card), flush=True)
            if th is not None:
                stop.set()
                th.join(timeout=5)


if __name__ == "__main__":
    main()
