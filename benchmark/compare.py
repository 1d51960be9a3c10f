"""The comparison that decides `correct`.

A driver hands over a sample of what the timed path produced: for each
stream, its input hops, the program's output hops, and how many of its
leading hops ran through the fused entry. The
plain reference of the configuration's kind enhances the same input from a
fresh state, in blocks of streams, and the sample is judged by

    err_rms = ||out - ref|| / ||ref||       over every sample of every stream

a share of the sample's own level, so it does not grow with a louder seed.
It is taken over the sample together, not stream by stream: a rounding
flip that the recurrence carries through one stretch of one stream (the
largest readings of the rehearsal; `PERF.md`) then weighs as the share of
the audio it touches. Each stream's own err_rms and err_peak are printed
beside, on standard error.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

BLOCK = 16
PCM_SCALE = 32768.0


def reference(run):
    mod = importlib.import_module(".reference." + run.config["kind"], __package__)
    return mod.Reference(run.config, run.model_path, run.device)


def reference_outputs(ref, items: List[Dict], precision: Dict, device) -> List[np.ndarray]:
    """The reference's output hops for each item, computed BLOCK streams at a
    time (zero-padded to the block's longest stream: the padding follows
    every compared hop, so it changes none of them)."""
    outs: List[np.ndarray] = []
    for lo in range(0, len(items), BLOCK):
        block = items[lo:lo + BLOCK]
        t_max = max(len(it["hops"]) for it in block)
        hops = torch.zeros((len(block), t_max, 256), dtype=torch.float32, device=device)
        for i, it in enumerate(block):
            hops[i, :len(it["hops"])] = torch.as_tensor(it["hops"], device=device)
        fused = {it.get("fused_hops", 0) for it in block}
        if len(fused) != 1:
            raise ValueError("a block mixes streams with different fused hops")
        y = ref.enhance(hops, precision, fused.pop())
        for i, it in enumerate(block):
            yi = y[i, :len(it["hops"])]
            outs.append(yi.cpu().numpy())
    return outs


def errors(out: np.ndarray, ref: np.ndarray):
    """-> (||d||^2, ||ref||^2, max |d|, max |ref|, the hop of the largest |d|)."""
    d = out.astype(np.float64) - ref.astype(np.float64)
    r = ref.astype(np.float64)
    return (float(np.sum(d * d)), float(np.sum(r * r)), float(np.max(np.abs(d))),
            float(np.max(np.abs(r))), int(np.argmax(np.max(np.abs(d), axis=-1))))


def compare(run, items: List[Dict], precision: Dict) -> Dict[str, float]:
    """-> {"err_rms": ||out - ref|| / ||ref|| over every compared stream
    together}, and per stream in `per_stream`: (its own err_rms, its
    err_peak = max |out - ref| / max |ref|, its loudest reference sample in
    LSB, the hop of its largest difference)."""
    if not items:
        return {}
    refs = reference_outputs(reference(run), items, precision, run.device)
    parts = [errors(it["out"], r) for it, r in zip(items, refs)]
    per = [(float(np.sqrt(d2 / max(r2, 1e-30))), dm / max(rm, 1e-30), rm * PCM_SCALE, hop)
           for d2, r2, dm, rm, hop in parts]
    return {"err_rms": float(np.sqrt(sum(p[0] for p in parts) / max(sum(p[1] for p in parts),
                                                                     1e-30))),
            "per_stream": per}


def control_items(run, items: List[Dict]) -> List[Dict]:
    """The sample with the program's outputs replaced by the control's: the
    reference at the configuration's `control` precision, put in the
    program's place."""
    precision = dict(run.config["precision"], **run.config["control"])
    outs = reference_outputs(reference(run), items, precision, run.device)
    return [dict(it, out=o) for it, o in zip(items, outs)]
