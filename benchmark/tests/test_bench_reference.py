"""The plain references agree with the port's CPU routes at tiny sizes, and
the controls (the references at the precision below the one each
configuration states) fail each cell's limits."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import audio, compare
from benchmark.reference import mask_gru as ref_gru
from benchmark.reference import mmse as ref_mmse
from benchmark.reference.pv import read_pv
from conftest import BENCH, REPO

MODEL = os.path.join(REPO, "models", "koala_params_tpu.pv")


def _hops(b, t, seed=5):
    bank = audio.Bank(REPO, "cpu")
    plan = audio.Plan(np.random.default_rng(seed), b, bank.length)
    return audio.mix_blocks(bank, plan, t * 256).reshape(b, t, 256)


def _worst(out, ref):
    """The largest stream's ||out - ref|| / ||ref||."""
    return max(float(np.sqrt(e[0] / e[1])) for e in (compare.errors(o.numpy(), r.numpy())
                                                     for o, r in zip(out, ref)))


def _program(kind, hops, **cfg_changes):
    from koala_tpu_torch.engine.core import make_engine
    from koala_tpu_torch.models import params_io
    from koala_tpu_torch.models.mmse import DEFAULT_CONFIG
    if kind == "mmse":
        tree, cfg = {"empty": np.zeros((1,), np.float32)}, dict(DEFAULT_CONFIG)
    else:
        tree, cfg = params_io.load_params(MODEL)
    cfg = dict(cfg, **cfg_changes)
    eng = make_engine(kind, cfg)
    params = params_io.params_from_numpy(tree, "cpu", kind)
    with torch.inference_mode():
        return eng, params, cfg, eng.sequence(params, eng.init_state((hops.shape[0],), "cpu"),
                                              hops)[1]


def test_mask_gru_matches_the_cpu_route():
    hops = _hops(3, 40)
    flat, cfg = read_pv(MODEL)
    ref = ref_gru.enhance(ref_gru.Weights(flat, cfg, "cpu"), hops, "bfloat16",
                          [(0, 40, "float32")])
    assert _worst(_program("mask_gru", hops)[3], ref) < 1e-5


def test_mask_gru_fused_plain_version_matches_with_bf16_spectra():
    """The fused entry's plain version takes bf16 operands in its spectral
    products; against the reference at those precisions it lies within the
    rounding of bf16, and ten times closer than against f32 spectra."""
    from koala_tpu_torch.ops.kernels.engine_fused import fused_sequence_ref
    hops = _hops(3, 40)
    eng, params, cfg, _ = _program("mask_gru", hops[:, :8])
    with torch.inference_mode():
        _, fused = fused_sequence_ref(params, eng.init_state((3,), "cpu"), hops, cfg)
    flat, file_cfg = read_pv(MODEL)
    w = ref_gru.Weights(flat, file_cfg, "cpu")
    near = _worst(fused, ref_gru.enhance(w, hops, "bfloat16", [(0, 40, "bfloat16")]))
    far = _worst(fused, ref_gru.enhance(w, hops, "bfloat16", [(0, 40, "float32")]))
    assert near < 2e-3 and far > 5 * near


def test_mmse_matches_the_cpu_route():
    with open(os.path.join(BENCH, "configs", "mmse.json")) as f:
        cfg = json.load(f)["model"]
    hops = _hops(3, 40)
    assert _worst(_program("mmse", hops)[3], ref_mmse.enhance(cfg, hops, "float32")) < 1e-6


def test_layers_kept():
    flat, cfg = read_pv(MODEL)
    keep = {}
    ref_gru.enhance(ref_gru.Weights(flat, cfg, "cpu"), _hops(1, 8), "bfloat16",
                    [(0, 8, "float32")], keep)
    assert {"spectrum", "features", "encoder", "gru0", "gru1", "mask"} <= set(keep)
    assert keep["features"].shape[-1] == 329


class _Run:
    def __init__(self, cell):
        config = cell.split(".")[0]
        with open(os.path.join(BENCH, "configs", config + ".json")) as f:
            self.config = json.load(f)
        with open(os.path.join(BENCH, "cells", cell + ".json")) as f:
            self.limits = json.load(f)["limits"]
        self.model_path = MODEL if self.config.get("model_file") else None
        self.device = torch.device("cpu")


@pytest.mark.parametrize("cell", ["koala-gru384x2.wash.b16384", "mmse.wash.b8192.pinned"])
def test_control_fails_the_cells_limits(cell):
    """The control, put in the program's place on 4 streams of 120 hops (the
    wash cells' fused hops included), reads past a limit of the cell; the
    reference itself reads 0."""
    run = _Run(cell)
    fused = 112 if run.config["kind"] == "mask_gru" else 0
    items = [{"hops": h.numpy(), "out": None, "fused_hops": fused}
             for h in _hops(4, 120, seed=11)]
    ctrl = compare.compare(run, compare.control_items(run, items), run.config["precision"])
    assert any(ctrl[k] > v for k, v in run.limits.items()), (ctrl, run.limits)
    refs = compare.reference_outputs(compare.reference(run), items, run.config["precision"], "cpu")
    same = compare.compare(run, [dict(it, out=r) for it, r in zip(items, refs)],
                           run.config["precision"])
    assert same["err_rms"] == 0.0 and all(p[:2] == (0.0, 0.0) for p in same["per_stream"])


def test_rounding_rules():
    x = torch.tensor([1.0, 1.0 + 2 ** -9, -3.0 - 2 ** -12, 1000.0])
    from benchmark.reference.stft import rnd
    assert torch.equal(rnd(x, "float32"), x)
    assert rnd(x, "bfloat16")[1] == 1.0
    t = rnd(x, "tf32")
    assert t[2] == -3.0 and t[1] == 1.0 + 2 ** -9
    f8 = rnd(x, "float8")
    assert f8[3] == pytest.approx(1000.0, rel=1e-6)        # the tensor's top maps to 448
    assert abs(float(f8[0]) - 1.0) > 0                      # 3 mantissa bits at 1/448 scale
