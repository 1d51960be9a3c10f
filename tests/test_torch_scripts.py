"""The port's counterparts of the scripts that need JAX, on the CPU at small
sizes: scripts/bench_sweep_torch.py, pod_wash_torch.py,
scaling_analysis_torch.py, soup_search_torch.py, promote_model_torch.py and
preship_check_torch.sh; and the two report readers that need no port
(gate_summary.py, ledger_from_report.py) on a report of
scripts/train_model_torch.py."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch_ref  # noqa: F401  (pins torch to 2 threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
MODEL = os.path.join(ROOT, "models", "koala_params_tpu.pv")
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def _load(name):
    """A script of scripts/ as a module (its ``main(argv)`` runs in-process)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(*args, env=None, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=dict(ENV, **(env or {})))


@pytest.fixture(scope="module")
def gate_run(tmp_path_factory):
    """The pre-ship gate's model step on the CPU, ``train_model_torch.py
    --eval-only --gate --allow-known-gaps --cpu``, also writing the bundled
    model's evaluation report (``--report``). (result, report path)."""
    path = str(tmp_path_factory.mktemp("report") / "report.json")
    r = _run(os.path.join(SCRIPTS, "train_model_torch.py"), "--eval-only", "--gate",
             "--allow-known-gaps", "--cpu", "--report", path)
    return r, path


@pytest.fixture(scope="module")
def torch_report(gate_run):
    """The bundled model's evaluation report, written by
    ``train_model_torch.py --eval-only --report`` on the CPU."""
    r, path = gate_run
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return path


# ---- bench_sweep_torch.py

SWEEP_KEYS = ["device", "name", "power_limit_w", "model", "batch", "frames", "iters",
              "sequence_ms", "full_sequence_ms", "fused_segments",
              "fused_stage_ms", "kernel_ms", "kernel_shape", "non_kernel_ms",
              "kernel_roofline", "fused_roofline", "components", "census", "sweep", "best"]
ROOFLINE_KEYS = ["bound_ms", "bound_by", "bytes_ms", "operations_ms", "tensor_fraction"]


def test_bench_sweep_writes_every_key_with_null_rooflines_on_the_cpu(tmp_path):
    out = tmp_path / "sweep.json"
    report = _load("bench_sweep_torch").main(
        ["--device", "cpu", "--batch", "2", "--frames", "16", "--iters", "1",
         "--sweep-batches", "2", "--sweep-frames", "8,16", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert set(SWEEP_KEYS) <= set(report)
    assert report["name"] == "cpu" and report["power_limit_w"] is None
    for roof in (report["kernel_roofline"], report["fused_roofline"],
                 report["components"]["floor_roofline"]):
        assert set(roof) == set(ROOFLINE_KEYS) and all(v is None for v in roof.values())
    assert report["kernel_shape"] == [16, 2, 384, 2] and report["kernel_ms"] > 0
    comp = report["components"]
    assert {"no_tracker_ms", "stft_istft_ms", "floor_scan_ms", "floor_shape"} <= set(comp)
    assert comp["floor_shape"] == [16, 2, 32]
    assert set(comp["host"]) == {"pcm_to_float_ms", "upload_ms", "download_ms",
                                 "float_to_pcm_ms", "samples"}
    assert comp["host"]["samples"] == 2 * 16 * 256
    census = report["census"]
    assert census["device_ms"] is None and census["wall_ms"] > 0
    assert set(census["groups"]) == {"port", "gemm", "elementwise_reduction", "copy"}
    assert census["groups"]["copy"]["bytes"]["copy_kernels"] > 0
    assert [(r["batch"], r["chunk_frames"]) for r in report["sweep"]] == [(2, 8), (2, 16)]
    for row in report["sweep"]:
        assert row["segments"] == 0 and row["audio_s_per_s"] > 0      # no fused entry here
    assert report["best"] in report["sweep"]


def test_bench_sweep_census_groups_a_card_trace(tmp_path):
    """The census reads a Chrome trace's device events into the four groups,
    with the memcpy bytes and the bytes that ``aten::copy_`` moves."""
    sweep = _load("bench_sweep_torch")
    events = [
        {"ph": "X", "cat": "kernel", "name": "void gru_stack_kernel<true, false>(...)", "dur": 1500},
        {"ph": "X", "cat": "kernel", "name": "floor_scan_kernel(float const*, ...)", "dur": 7},
        {"ph": "X", "cat": "kernel", "name": "nvjet_tst_128x64_64x4_1x2_h_bz_TNT", "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32_tf32f32", "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4, "
         "at::native::GeluCUDAKernelImpl>", "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void at::native::reduce_kernel<512, 1>", "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "void at::native::direct_copy_kernel_cuda", "dur": 3},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "dur": 10,
         "args": {"bytes": 1024}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "dur": 9,
         "args": {"Input Dims": [[2, 3], [2, 3], []],
                  "Input type": ["c10::BFloat16", "float", "Scalar"]}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    groups = sweep.census_of_trace(str(path))
    assert {g: groups[g]["count"] for g in groups} == {
        "port": 2, "gemm": 2, "elementwise_reduction": 2, "copy": 2}
    assert groups["port"]["device_ms"] == pytest.approx(1.507)
    assert groups["copy"]["bytes"] == {"memcpy": 1024, "copy_kernels": 6 * 2 + 6 * 4}


def test_bench_sweep_refuses_without_a_card():
    r = _run(os.path.join(SCRIPTS, "bench_sweep_torch.py"), "--out", os.devnull,
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and "best" not in r.stdout


# ---- pod_wash_torch.py

def test_pod_wash_on_two_cpu_shards_reports_scaling_efficiency(monkeypatch, capsys):
    monkeypatch.setenv("KOALA_POD_CPU_DEVICES", "2")
    records = _load("pod_wash_torch").main(
        ["--utterances", "8", "--utterance-seconds", "0.25", "--efficiency"])
    out = capsys.readouterr().out
    assert out.startswith("machine state: ")
    assert [r.get("tag") for r in records] == ["all-devices", "one-device", None]
    full, single, eff = records
    assert (full["chips"], single["chips"]) == (2, 1)
    for r in (full, single):
        assert r["batches"] == 1 and r["audio_seconds"] == pytest.approx(4 * 0.24)
        assert r["audio_seconds_per_second"] > 0
    # the keys of scripts/pod_wash.py's record
    assert set(eff) == {"metric", "chips", "value", "aggregate_retention", "virtual_cpu_mesh"}
    assert eff["metric"] == "scaling_efficiency" and eff["chips"] == 2
    assert eff["virtual_cpu_mesh"] is True and eff["value"] > 0


def test_pod_wash_asks_for_the_card(monkeypatch):
    import torch

    from koala_tpu_torch import KoalaInvalidArgumentError

    monkeypatch.delenv("KOALA_POD_CPU_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KoalaInvalidArgumentError):
        _load("pod_wash_torch").main(["--utterances", "4", "--utterance-seconds", "0.1"])


# ---- scaling_analysis_torch.py

def test_scaling_analysis_counts_the_collectives_that_ran(tmp_path):
    r = _run(os.path.join(SCRIPTS, "scaling_analysis_torch.py"), "--procs", "2", "--out-dir",
             str(tmp_path), "--batch", "8", "--frames", "8", "--iters", "1",
             "--shards", "1,2,4,8")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    report = json.loads((tmp_path / "scaling_analysis_torch.json").read_text())
    census = report["collective_census"]
    assert census["processes"] == 2
    # a wash batch: nothing; a wash: the report's one sum of audio seconds
    assert census["wash_batch"] == {}
    assert census["wash"] == {"all_reduce": {"calls": 1, "bytes": 8}}
    # a data-parallel step: one reduction of the gradients and the loss
    assert census["train_step"] == {"all_reduce": {"calls": 1,
                                                   "bytes": census["gradient_bytes_expected"]}}
    rows = report["retention_sweep"]["rows"]
    assert [row["devices"] for row in rows] == [1, 2, 4, 8]
    assert rows[0]["aggregate_retention"] == 1.0 and all(row["audio_s_per_s"] > 0 for row in rows)
    md = (tmp_path / "SCALING_torch.md").read_text()
    assert "all_reduce x 1" in md and "| 8 |" in md


# ---- soup_search_torch.py

def test_soup_of_the_model_with_itself_is_the_model(tmp_path, monkeypatch):
    from koala_tpu_torch.models import params_io

    soup_search = _load("soup_search_torch")
    name, members = soup_search.parse_spec("self=1:%s,1:%s" % (MODEL, MODEL))
    assert name == "self" and members == [(0.5, MODEL), (0.5, MODEL)]
    tree, cfg = soup_search.soup(members)
    want, want_cfg = params_io.load_params(MODEL)
    assert cfg == want_cfg
    flat_a, flat_b = torch_ref.flat_tree(tree), torch_ref.flat_tree(want)
    assert flat_a.keys() == flat_b.keys()
    for key in flat_a:
        np.testing.assert_array_equal(flat_a[key], flat_b[key], err_msg=key)

    # main writes the blob and the report; the evaluation is the training
    # script's (its own test runs it), here a fixed report
    with open(os.path.join(ROOT, "models", "train_report.json")) as fh:
        fixed = json.load(fh)
    monkeypatch.setattr(importlib.import_module("train_model_torch"), "eval_all",
                        lambda params, cfg: fixed)
    written = soup_search.main(["self=0.5:%s,0.5:%s" % (MODEL, MODEL),
                                "--out-dir", str(tmp_path)])
    blob, report = written["self"]
    loaded, _ = params_io.load_params(blob)
    for key, value in torch_ref.flat_tree(loaded).items():
        np.testing.assert_array_equal(value, flat_b[key], err_msg=key)
    assert json.loads(open(report).read()) == fixed


# ---- promote_model_torch.py

def test_promote_refuses_a_failing_report_and_promotes_a_passing_one(tmp_path, torch_report):
    promote = _load("promote_model_torch")
    models = tmp_path / "models"
    models.mkdir()
    (models / "koala_params_tpu_r9.pv").write_bytes(b"stale")
    (models / "train_report_r9.json").write_text("{}")
    with open(torch_report) as fh:
        passing = json.load(fh)
    failing = json.loads(json.dumps(passing))
    failing["synth_fixture"]["dev_mixed"] = 0.5                 # a gap the ledger does not hold
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(failing))
    assert promote.main([MODEL, str(bad), "--models-dir", str(models)]) == 1
    assert sorted(os.listdir(models)) == ["koala_params_tpu_r9.pv", "train_report_r9.json"]

    candidate = tmp_path / "candidate.pv"
    shutil.copyfile(MODEL, candidate)
    assert promote.main([str(candidate), torch_report, "--models-dir", str(models)]) == 0
    assert sorted(os.listdir(models)) == ["koala_params_tpu.pv", "train_report.json"]
    assert (models / "koala_params_tpu.pv").read_bytes() == candidate.read_bytes()
    assert json.loads((models / "train_report.json").read_text()) == passing


# ---- the report readers that need no port

def test_gate_summary_and_ledger_read_a_train_model_torch_report(torch_report):
    sys.path.insert(0, SCRIPTS)
    from ledger_from_report import gaps

    from known_gaps import KNOWN_GAPS

    with open(torch_report) as fh:
        report = json.load(fh)
    found = gaps(report)
    # the bundled model's gaps are the ledger's, by set and check
    assert set(found) <= set(KNOWN_GAPS)
    failing_sets = {name for name, _ in found}

    r = _run(os.path.join(SCRIPTS, "gate_summary.py"), torch_report)
    assert r.returncode == (1 if failing_sets else 0), r.stderr      # exit 1 on any fail
    for name in report:
        assert name in r.stdout
    assert "fails: %d " % len(failing_sets) in r.stdout

    r = _run(os.path.join(SCRIPTS, "ledger_from_report.py"), torch_report)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("KNOWN_GAPS = {") and r.stdout.rstrip().endswith("}")
    for (name, check) in found:
        assert '("%s", "%s")' % (name, check) in r.stdout


# ---- preship_check_torch.sh

# Stand-ins for ``python`` and ``python3`` on the gate's PATH: each logs its
# arguments and answers as the step would, or fails the step named in
# STUB_FAIL. The real steps have their own tests: the port's tests are this
# suite, bench_torch.py's are in tests/test_torch_bench.py, and the model
# step runs for real in ``gate_run``.
STUB = """#!/usr/bin/env bash
echo "$*" >> "$STUB_LOG"
case "$*" in
  "-m pytest"*)
    if [ "$STUB_FAIL" = pytest ]; then echo "1 failed, 4 passed in 0.1s"; else echo "5 passed in 0.1s"; fi ;;
  bench_torch.py*)
    if [ "$STUB_FAIL" = bench ]; then echo "no CUDA card" >&2; exit 1; fi
    echo '{"engine_audio_s_per_s": 1.0}' ;;
  scripts/train_model_torch.py*)
    if [ "$STUB_FAIL" = gate ]; then echo "GATE FAIL synth_fixture dev_mixed"; exit 1; fi
    echo "ALL GATES PASS" ;;
  *) exit 2 ;;
esac
"""
STEPS = ["bench_torch.py",
         "scripts/train_model_torch.py --eval-only --gate --allow-known-gaps --cpu"]


def _steps_in_order(calls):
    """The gate's calls are the port's tests (every tests/test_torch_*.py,
    as the shell expands the pattern), then STEPS, and nothing else."""
    tests = sorted(os.path.relpath(os.path.join(ROOT, "tests", f), ROOT)
                   for f in os.listdir(os.path.join(ROOT, "tests"))
                   if f.startswith("test_torch_") and f.endswith(".py"))
    words = calls[0].split() if calls else []
    return (words[:2] == ["-m", "pytest"] and words[-3:] == ["-q", "-p", "no:cacheprovider"]
            and sorted(words[2:-3]) == tests and calls[1:] == STEPS)


def _preship(tmp_path, fail=""):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for name in ("python", "python3"):
        (bin_dir / name).write_text(STUB)
        (bin_dir / name).chmod(0o755)
    log, out = tmp_path / "calls.log", tmp_path / "preship"
    log.write_text("")
    env = dict(ENV, PATH="%s:%s" % (bin_dir, os.environ["PATH"]), STUB_LOG=str(log),
               STUB_FAIL=fail, KOALA_PRESHIP_OUT=str(out))
    r = subprocess.run(["bash", os.path.join(SCRIPTS, "preship_check_torch.sh")], cwd=ROOT,
                       capture_output=True, text=True, timeout=60, env=env)
    return r, log.read_text().splitlines(), out


def test_preship_runs_tests_bench_and_gate_and_reports_green(tmp_path, gate_run):
    r, calls, out = _preship(tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.rstrip().endswith("PRESHIP: ALL GREEN")
    assert _steps_in_order(calls), calls
    assert sorted(os.listdir(out)) == ["bench.err", "bench.json", "gate.txt", "pytest.txt"]
    assert (out / "pytest.txt").read_text().strip() == "5 passed in 0.1s"
    assert json.loads((out / "bench.json").read_text()) == {"engine_audio_s_per_s": 1.0}
    # the model step itself, run for real on the CPU, passes on the bundled model
    gate, _ = gate_run
    assert gate.returncode == 0, gate.stdout[-2000:] + gate.stderr[-2000:]
    assert "ALL GATES PASS" in gate.stdout


def test_preship_is_red_when_a_step_fails(tmp_path):
    """Any one step failing turns the gate red; the others still run."""
    for step, said in (("pytest", ["1 failed"]),
                       ("bench", ["bench_torch.py FAILED", "no CUDA card"]),
                       ("gate", ["MODEL GATE FAILED", "GATE FAIL synth_fixture dev_mixed"])):
        r, calls, _ = _preship(tmp_path, fail=step)
        assert r.returncode == 1, (step, r.stdout)
        assert all(s in r.stdout for s in said), (step, r.stdout)
        assert r.stdout.rstrip().endswith("PRESHIP: RED - do not ship")
        assert _steps_in_order(calls), calls
