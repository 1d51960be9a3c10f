"""The mmse gain recurrence (ops/kernels/mmse.py, models/mmse.py) on the CPU:
the module imports without nvcc, CPU tensors take the plain version,
``apply_sequence`` is the frame-by-frame ``step`` fold bit for bit, the
kernel's bound counts its bytes, and the ``mmse.gain`` span carries its
counts. The kernel itself is held to its plain version in
tests/test_torch_cuda.py."""

import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

from koala_tpu_torch import profiling
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models import mmse
from koala_tpu_torch.ops.kernels import _build
from koala_tpu_torch.ops.kernels import mmse as kernel

import torch_ref  # noqa: F401  (pins torch to 2 threads)

RULE = mmse.gain_rule(None)


def _spectra(seed, shape):
    """re, im of ``shape`` [..., T, K], each frame at its own level, from
    1e-6 to 1e3, so the SNR clamps at both ends are reached."""
    rng = np.random.default_rng(seed)
    level = np.exp(rng.uniform(np.log(1e-6), np.log(1e3), shape[:-1] + (1,)))
    return tuple(torch.as_tensor((rng.standard_normal(shape) * level).astype(np.float32))
                 for _ in range(2))


def _step_fold(state, re, im):
    masks = []
    for t in range(re.shape[-2]):
        state, mask = mmse.step(None, state, re[..., t, :], im[..., t, :], mmse.DEFAULT_CONFIG)
        masks.append(mask)
    return state, torch.stack(masks, dim=-2)


def test_kernel_module_imports_without_building(monkeypatch):
    """Importing the module builds nothing: the CPU has no nvcc."""
    def refuse():
        raise AssertionError("the kernel library was built at import")

    monkeypatch.setattr(_build, "library", refuse)
    module = importlib.reload(kernel)
    assert module.launches == 0 and callable(module.mmse_gain)


def test_cpu_tensors_take_the_plain_version():
    re, im = _spectra(0, (3, 20, 257))
    state = mmse.init_state((3,), mmse.DEFAULT_CONFIG, "cpu")
    args = (re, im, state["noise"], state["prev_gain2_post"], state["count"]) + RULE
    before = kernel.launches
    got = kernel.mmse_gain(*args)
    want = kernel.mmse_gain_ref(*args)
    assert kernel.launches == before
    assert got[3].shape == (3, 20, 257)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("lead", [(), (4,)], ids=["T_K", "B_T_K"])
def test_apply_sequence_is_the_step_fold_bit_for_bit(lead):
    re, im = _spectra(1, lead + (60, 257))
    state = mmse.init_state(lead, mmse.DEFAULT_CONFIG, "cpu")
    got_state, got = mmse.apply_sequence(None, state, re, im, mmse.DEFAULT_CONFIG)
    want_state, want = _step_fold(state, re, im)
    assert got.shape == re.shape and torch.equal(got, want)
    assert sorted(got_state) == sorted(want_state)
    for k, v in want_state.items():
        assert got_state[k].shape == v.shape and torch.equal(got_state[k], v), k


def test_apply_sequence_carries_state_across_calls():
    """Two calls over 25 and 35 frames give one call's masks and state."""
    re, im = _spectra(2, (2, 60, 257))
    state = mmse.init_state((2,), mmse.DEFAULT_CONFIG, "cpu")
    one_state, one = mmse.apply_sequence(None, state, re, im)
    mid, first = mmse.apply_sequence(None, state, re[:, :25], im[:, :25])
    end, second = mmse.apply_sequence(None, mid, re[:, 25:], im[:, 25:])
    assert torch.equal(torch.cat([first, second], dim=1), one)
    assert all(torch.equal(end[k], one_state[k]) for k in one_state)


def test_no_frames_leave_the_state_as_it_was():
    state = mmse.init_state((2,), mmse.DEFAULT_CONFIG, "cpu")
    re = torch.zeros(2, 0, 257)
    got_state, mask = mmse.apply_sequence(None, state, re, re)
    assert mask.shape == (2, 0, 257)
    assert all(torch.equal(got_state[k], state[k]) for k in state)


def test_bound_counts_the_bytes():
    """re, im and the mask once, noise and prev_gain2_post both ways, count
    both ways; no products, so bytes bound it: 2.84 ms at the wash's shape."""
    b = kernel.bound(375, 8192, 257)
    want = (3 * 8192 * 375 * 257 + 4 * 8192 * 257 + 2 * 8192) * 4
    assert b["operations"] == 0.0
    assert b["bytes"] == pytest.approx(want / profiling.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert round(b["bytes"], 2) == 2.84


def test_gain_span_carries_its_counts():
    """Under a profiler, a CPU sequence call records ``mmse.gain`` inside
    ``engine.model``: its frames, its columns (N x K) and no kernel launch."""
    engine = make_engine("mmse", mmse.DEFAULT_CONFIG)
    hops = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 7, 256))
                           .astype(np.float32) * 0.1)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.sequence(mmse.init_params(), engine.init_state((3,), "cpu"), hops)
    (s,) = [s for s in profiling.spans(t0) if s.name == "mmse.gain"]
    assert s.counts == {"frames": 7, "columns": 3 * 257, "kernel": 0}
    assert s.parent == "engine.model"


def test_census_counts_the_gain_kernel_as_a_port_kernel(tmp_path):
    """scripts/bench_sweep_torch.py's census groups the gain kernel with the
    port's kernels."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench_sweep_torch", os.path.join(here, "scripts", "bench_sweep_torch.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    name = ("(anonymous namespace)::mmse_gain_kernel(float const*, float const*, float const*, "
            "float const*, float const*, float*, float*, float*, float*, int, int, int, "
            "(anonymous namespace)::GainRule)")
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "dur": 3000, "name": name}]}))
    assert sweep.census_of_trace(str(path))["port"]["count"] == 1


def _times_script():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "mmse_times_torch", os.path.join(here, "scripts", "mmse_times_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def test_times_script_cases_are_seeded_fresh_streams():
    """scripts/mmse_times_torch.py's inputs: the same seed gives the same
    spectra, the state is a fresh stream's, and the plain version runs them."""
    script = _times_script()
    a, b = script.gain_case(3, 5, "cpu", seed=4), script.gain_case(3, 5, "cpu", seed=4)
    assert a[0].shape == a[1].shape == (3, 5, 257)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(a[4].abs().max()) == 0.0 and a[2].shape == (3, 257)
    out = kernel.mmse_gain_ref(*a, *mmse.gain_rule(None))
    assert out[3].shape == (3, 5, 257) and torch.equal(out[2], torch.full((3,), 5.0))


def test_times_script_refuses_to_run_without_a_card():
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is here: the script would measure")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(here, "scripts", "mmse_times_torch.py")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "needs a CUDA card" in r.stderr
