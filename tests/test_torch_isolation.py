"""koala_tpu_torch stands alone: it imports neither jax nor koala_tpu, and
its entry points never carry on on the CPU when a card was asked for."""

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


def test_source_names_no_jax_or_koala_tpu():
    """No ``import jax`` and no ``koala_tpu`` other than ``koala_tpu_torch``
    anywhere in the package's sources (Python and CUDA)."""
    bad = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if (re.search(r"\bimport\s+jax\b|\bfrom\s+jax\b", line)
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
