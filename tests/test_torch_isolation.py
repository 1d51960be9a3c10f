"""koala_tpu_torch stands alone: it imports neither jax, optax nor koala_tpu,
and its entry points never carry on on the CPU when a card was asked for."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

import koala_tpu_torch
from koala_tpu_torch import KoalaInvalidArgumentError
from koala_tpu_torch.device import parse_device, resolve_torch_device

from torch_ref import ACCESS_KEY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "koala_tpu_torch")


def test_import_leaves_no_jax_or_koala_tpu():
    code = ("import sys, koala_tpu_torch, koala_tpu_torch.engine.core; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'koala_tpu' or m.startswith('koala_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


TRAIN_MODULES = ["corpus", "data", "device_sampler", "evaluate", "fwsnrseg", "pseudo_real",
                 "stoi", "train"]
TRAIN_SCRIPT = os.path.join(ROOT, "scripts", "train_model_torch.py")


@pytest.mark.parametrize("module", TRAIN_MODULES)
def test_train_module_import_leaves_no_jax_optax_or_koala_tpu(module):
    code = ("import sys, importlib; importlib.import_module('koala_tpu_torch.train.%s'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', "
            "'koala_tpu')]; print(bad); sys.exit(1 if bad else 0)" % module)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_train_script_imports_no_jax_optax_or_koala_tpu():
    """Loading the training script and the modules its functions import pulls
    in none of the three (its help text runs the argument parser only)."""
    code = ("import sys, runpy; sys.argv = ['train_model_torch.py', '--help']\n"
            "try:\n    runpy.run_path(%r, run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "import koala_tpu_torch.train.train, koala_tpu_torch.train.evaluate\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', "
            "'koala_tpu')]; print(bad); sys.exit(1 if bad else 0)" % TRAIN_SCRIPT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "--segment-frames" in r.stdout and "--allow-known-gaps" in r.stdout


SERVING_MODULES = ["serve", "hostlib", "websocket", "profiling", "parallel", "parallel.mesh",
                   "parallel.runner", "models.mmse"]
FRONT_SCRIPTS = [os.path.join(ROOT, "scripts", s)
                 for s in ("serve_tcp_torch.py", "serve_web_torch.py")]


@pytest.fixture(scope="module")
def serving_imports():
    """One interpreter imports the serving modules one after another and
    records, after each, which of jax, optax and koala_tpu are loaded:
    imports only accumulate, so a module that pulled one in shows it."""
    code = ("import sys, json, importlib\nseen = {}\n"
            "for m in %r:\n"
            "    importlib.import_module('koala_tpu_torch.' + m)\n"
            "    seen[m] = [n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'koala_tpu')]\n"
            "print(json.dumps(seen))" % SERVING_MODULES)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_module_import_leaves_no_jax_optax_or_koala_tpu(module, serving_imports):
    assert serving_imports[module] == []


@pytest.mark.parametrize("script", FRONT_SCRIPTS)
def test_front_script_imports_no_jax_optax_or_koala_tpu(script):
    """A front's help text, then the modules its functions import: none of
    the three is loaded."""
    code = ("import sys, runpy; sys.argv = [%r, '--help']\n"
            "try:\n    runpy.run_path(%r, run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "import koala_tpu_torch.serve, koala_tpu_torch.websocket\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', "
            "'koala_tpu')]; print(bad); sys.exit(1 if bad else 0)"
            % (os.path.basename(script), script))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "--device" in r.stdout and "--streams" in r.stdout


def test_serving_and_parallel_entry_points_ask_for_the_card(monkeypatch):
    """With no device argument the server, the corpus runner and the mesh
    take the card, and raise the typed error without one."""
    from koala_tpu_torch.models.params_io import default_model_path
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh
    from koala_tpu_torch.serve import StreamingServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KoalaInvalidArgumentError):
        StreamingServer(ACCESS_KEY, num_streams=2)
    with pytest.raises(KoalaInvalidArgumentError):
        CorpusRunner(default_model_path(), global_batch=2, utterance_samples=1024)
    with pytest.raises(KoalaInvalidArgumentError):
        make_mesh()


def _package_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, f)


def test_source_names_no_jax_or_koala_tpu():
    """No ``import jax`` or ``import optax`` and no ``koala_tpu`` other than
    ``koala_tpu_torch`` anywhere in the package's sources (Python and CUDA)
    nor in the training script and the network fronts."""
    bad = []
    paths = list(_package_sources()) + [TRAIN_SCRIPT] + FRONT_SCRIPTS
    assert all(os.path.join(PKG, "train", m + ".py") in paths for m in TRAIN_MODULES)
    for path in paths:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if (re.search(r"\b(import|from)\s+(jax|optax)\b", line)
                        or re.search(r"\bkoala_tpu(?!_torch)\b", line)):
                    bad.append("%s:%d %s" % (path, i, line.strip()))
    assert not bad, bad


def test_chip_smoke_imports_no_jax_or_koala_tpu():
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        imports = [line.strip() for line in fh
                   if re.match(r"\s*(import|from)\s+\w", line)]
    assert imports
    bad = [line for line in imports
           if re.search(r"^(import|from)\s+(jax|koala_tpu(?!_torch))\b", line)]
    assert not bad, bad


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(where, tmp_path):
    """No CUDA card here: the smoke run exits nonzero and prints no result,
    both from the checkout and as a lone copy of the script."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("device", ["best", "gpu", "gpu:0"])
def test_card_devices_raise_without_a_card(device, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KoalaInvalidArgumentError):
        resolve_torch_device(parse_device(device))
    with pytest.raises(KoalaInvalidArgumentError):
        koala_tpu_torch.create(ACCESS_KEY, device=device)
    with pytest.raises(KoalaInvalidArgumentError):
        koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=2, device=device)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KoalaInvalidArgumentError):
        koala_tpu_torch.create(ACCESS_KEY)


def test_tpu_and_bad_grammar_raise():
    for device in ("tpu", "tpu:0", "quantum:0", ""):
        with pytest.raises(KoalaInvalidArgumentError):
            resolve_torch_device(parse_device(device))


def test_cpu_is_explicit():
    for device in ("cpu", "cpu:1", "cpu:4"):
        assert resolve_torch_device(parse_device(device)) == torch.device("cpu")


PORT_SCRIPTS = [os.path.join(ROOT, "bench_torch.py")] + [
    os.path.join(ROOT, "demo", "koala_demo_%s_torch.py" % d)
    for d in ("file", "longform", "batch", "mic")]


def test_bench_and_demos_import_no_jax_optax_or_koala_tpu():
    """The port's bench and demos, loaded as modules with the package
    modules their functions import: none of the three is loaded, and no line
    of their sources names one."""
    code = ("import sys, importlib.util\n"
            "for i, path in enumerate(%r):\n"
            "    spec = importlib.util.spec_from_file_location('s%%d' %% i, path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "import koala_tpu_torch, koala_tpu_torch.io, koala_tpu_torch.serve\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', "
            "'koala_tpu')]; print(bad); sys.exit(1 if bad else 0)" % PORT_SCRIPTS)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    bad = []
    for path in PORT_SCRIPTS:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if (re.search(r"\b(import|from)\s+(jax|optax)\b", line)
                        or re.search(r"\bkoala_tpu(?!_torch)\b", line)):
                    bad.append("%s:%d %s" % (path, i, line.strip()))
    assert not bad, bad


@pytest.mark.parametrize("script", PORT_SCRIPTS, ids=os.path.basename)
def test_bench_and_demos_ask_for_the_card_by_default(script, tmp_path, monkeypatch):
    """Run with no --device, each raises the typed error without a card."""
    import importlib.util

    import numpy as np

    from koala_tpu_torch.io import write_wav

    wav = str(tmp_path / "in.wav")
    write_wav(wav, np.zeros(4096, np.int16))
    args = {"bench_torch.py": [],
            "koala_demo_file_torch.py": ["--input_path", wav, "--output_path", wav + ".out"],
            "koala_demo_longform_torch.py": ["--input_path", wav, "--output_path",
                                             wav + ".out"],
            "koala_demo_batch_torch.py": ["--input_dir", str(tmp_path), "--output_dir",
                                          str(tmp_path / "out")],
            "koala_demo_mic_torch.py": ["--input_path", wav]}[os.path.basename(script)]
    spec = importlib.util.spec_from_file_location("_port_script", script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KoalaInvalidArgumentError):
        module.main(args)


# the counterparts of the scripts that need JAX, the two data generators
# among them, and the two report readers that need no port
PART_B_SCRIPTS = [os.path.join(ROOT, "scripts", s + ".py") for s in (
    "bench_sweep_torch", "pod_wash_torch", "scaling_analysis_torch", "soup_search_torch",
    "promote_model_torch", "make_corpus_torch", "make_fixtures_torch", "gate_summary",
    "ledger_from_report")]


def test_ported_scripts_import_no_jax_optax_or_koala_tpu():
    """Each script loaded as a module, with the modules that its functions
    import (the training script's gates and evaluation, the ledger): none of
    jax, optax and koala_tpu is loaded, and no line of their sources (nor of
    the pre-ship script) names one."""
    code = ("import sys, importlib.util\n"
            "sys.path[:0] = [%r, %r]\n"
            "for i, path in enumerate(%r):\n"
            "    spec = importlib.util.spec_from_file_location('s%%d' %% i, path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "import train_model_torch, known_gaps, koala_tpu_torch.parallel\n"
            "import koala_tpu_torch.train.train, koala_tpu_torch.train.evaluate\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', "
            "'koala_tpu')]; print(bad); sys.exit(1 if bad else 0)"
            % (os.path.join(ROOT, "scripts"), os.path.join(ROOT, "tests"), PART_B_SCRIPTS))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    bad = []
    for path in PART_B_SCRIPTS + [os.path.join(ROOT, "scripts", "preship_check_torch.sh")]:
        ported = "_torch" in os.path.basename(path)
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if (re.search(r"\b(import|from)\s+(jax|optax)\b", line)
                        or re.search(r"\bkoala_tpu(?!_torch)\b", line)
                        # a ported script runs the port's bench and trainer only
                        or (ported and re.search(r"\b(bench|train_model)\.py\b", line))):
                    bad.append("%s:%d %s" % (path, i, line.strip()))
    assert not bad, bad
