"""The port's data generators against the JAX package's: scripts/make_corpus_torch.py
and scripts/make_fixtures_torch.py write the same files, byte for byte, as
scripts/make_corpus.py and scripts/make_fixtures.py, each into a directory
of its own. The JAX scripts run unchanged from a copy whose repository root
is a temporary directory; the port's take their output directories as module
constants."""

import importlib.util
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV_SAMPLES = 93680                      # 5.855 s at 16 kHz
SMALL_TAPES = ["--speech-utts", "2", "--noise-clips", "2"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_script(name, root, monkeypatch):
    """scripts/<name>.py copied under ``root``/scripts and loaded from there,
    so that its repository root, and every path it writes, is ``root``. The
    entry that it puts on ``sys.path`` goes with the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    os.makedirs(os.path.join(root, "scripts"))
    path = os.path.join(root, "scripts", name + ".py")
    shutil.copy(os.path.join(ROOT, "scripts", name + ".py"), path)
    return _load(path, "_jax_" + name)


def _port_script(name):
    return _load(os.path.join(ROOT, "scripts", name + ".py"), "_port_" + name)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _wav_samples(blob):
    return (len(blob) - 44) // 2


def test_make_corpus_torch_writes_the_jax_scripts_bytes(tmp_path, monkeypatch):
    """Small tapes (2 utterances, 2 clips, the floor tape's least 50 clips)
    and two battery pairs, babble among them, through each script's main."""
    jax_mod = _jax_script("make_corpus", str(tmp_path / "jax"), monkeypatch)
    port = _port_script("make_corpus_torch")
    for key in ("TRAIN_SPEECH_SEED", "TRAIN_NOISE_SEED", "TRAIN_FLOOR_SEED",
                "DEV_SPEECH_SEED", "DEV_NOISE_SEED", "DEV_BATTERY"):
        assert getattr(port, key) == getattr(jax_mod, key), key
    subset = [row for row in port.DEV_BATTERY if row[3] in ("am", "babble")]
    jax_mod.DEV_BATTERY = subset
    monkeypatch.setattr(sys, "argv", ["make_corpus.py"] + SMALL_TAPES)
    jax_mod.main()
    monkeypatch.setattr(port, "DEV_BATTERY", subset)
    monkeypatch.setattr(port, "CORPUS_DIR", str(tmp_path / "port" / "resources" / "corpus"))
    monkeypatch.setattr(port, "SAMPLES_DIR",
                        str(tmp_path / "port" / "resources" / "audio_samples"))
    port.main(SMALL_TAPES)
    want = _tree(str(tmp_path / "jax" / "resources"))
    got = _tree(str(tmp_path / "port" / "resources"))
    assert sorted(got) == sorted(want) == sorted(
        [os.path.join("corpus", n + "_tape.npy") for n in ("speech", "noise", "floor")]
        + [os.path.join("audio_samples", "%s_dev%s.wav" % (kind, tag))
           for tag in ("", "5") for kind in ("speech", "noise")])
    for name in want:
        assert got[name] == want[name], name
        if name.endswith(".wav"):
            assert _wav_samples(got[name]) == DEV_SAMPLES, name


def test_make_fixtures_torch_writes_the_jax_scripts_bytes(tmp_path, monkeypatch):
    jax_mod = _jax_script("make_fixtures", str(tmp_path / "jax"), monkeypatch)
    port = _port_script("make_fixtures_torch")
    for key in ("DURATION_S", "N", "SPEECH_SEED", "NOISE_SEED"):
        assert getattr(port, key) == getattr(jax_mod, key), key
    jax_mod.main()
    out = tmp_path / "port" / "resources" / "audio_samples"
    monkeypatch.setattr(port, "OUT_DIR", str(out))
    port.main()
    want = _tree(str(tmp_path / "jax" / "resources"))
    got = _tree(str(tmp_path / "port" / "resources"))
    assert sorted(got) == sorted(want) == [os.path.join("audio_samples", n)
                                           for n in ("noise_synth.wav", "speech_synth.wav")]
    for name in want:
        assert got[name] == want[name], name
        assert _wav_samples(got[name]) == DEV_SAMPLES, name


@pytest.mark.parametrize("script", ["make_corpus_torch", "make_fixtures_torch"])
def test_generators_default_to_the_repository(script):
    """Run with no redirection, each writes where its JAX original does."""
    port = _port_script(script)
    samples = os.path.join(ROOT, "resources", "audio_samples")
    if script == "make_corpus_torch":
        assert port.CORPUS_DIR == os.path.join(ROOT, "resources", "corpus")
        assert port.SAMPLES_DIR == samples
    else:
        assert port.OUT_DIR == samples
