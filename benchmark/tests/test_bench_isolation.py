"""What the benchmark loads and where it refuses to run.

Module names are compared whole by their top-level name (the part before
the first dot): `koala_tpu_torch` is the program, `koala_tpu` the JAX
package that it must never load.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "koala_tpu"}
PROGRAM = "koala_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(*sub):
    folder = os.path.join(BENCH, *sub)
    return [os.path.join(folder, f) for f in sorted(os.listdir(folder)) if f.endswith(".py")]


def _top_level(names):
    return {n.split(".")[0] for n in names}


def test_no_source_imports_jax_or_the_jax_package():
    for path in (_sources() + _sources("drivers") + _sources("metrics") + _sources("counts")
                 + _sources("reference")):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_and_counts_import_nothing_of_the_program():
    for path in (_sources("reference") + _sources("counts")
                 + [os.path.join(BENCH, "compare.py")]):
        assert PROGRAM not in set(_imports(path)), path
    code = ("import sys, json\n"
            "import benchmark.compare, benchmark.reference.mask_gru, benchmark.reference.mmse\n"
            "import benchmark.counts.mask_gru, benchmark.counts.mmse\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM not in loaded and not loaded & FORBIDDEN


def test_a_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh interpreter: the program is loaded, no
    module named jax, jaxlib, flax or koala_tpu."""
    code = ("import sys, json, io\n"
            "from benchmark.harness import run_cell\n"
            "out = io.StringIO()\n"
            "rc = run_cell(%r, 'mmse.wash.tiny', 3, 0.5, 1, device='cpu',\n"
            "              bench_dir=%r, out=out, err=io.StringIO())\n"
            "print(json.dumps({'rc': rc, 'line': out.getvalue().strip(),\n"
            "                  'modules': sorted({m.split('.')[0] for m in sys.modules})}))\n"
            % (tiny_root, os.path.join(tiny_root, "benchmark")))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and json.loads(res["line"])["correct"] is True
    assert PROGRAM in res["modules"]
    assert not set(res["modules"]) & FORBIDDEN


def _run_py(cwd):
    return subprocess.run([sys.executable, os.path.join(cwd, "benchmark", "run.py"),
                           "--workload", "koala-gru384x2.wash.b16384", "--seed", "3000000001",
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = _run_py(REPO)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_alone_it_refuses(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder (no program, no model, no audio) it exits nonzero, no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(str(tmp_path))
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_forbidden_module_refuses(tiny_root, monkeypatch):
    """A run whose process holds a module of the JAX package exits nonzero
    and prints no result, naming what it found."""
    import types

    from conftest import run_tiny
    monkeypatch.setitem(sys.modules, "koala_tpu", types.ModuleType("koala_tpu"))
    rc, line, err = run_tiny(tiny_root, "mmse.wash.tiny", seconds=0.3)
    assert rc != 0 and line is None and "koala_tpu" in err
