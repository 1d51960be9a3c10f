"""The port's data-parallel layer (koala_tpu_torch/parallel) on CPU shards,
held against koala_tpu's engine and corpus runner."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from koala_tpu.constants import FRAME_LENGTH
from koala_tpu.engine.core import make_engine as jmake_engine
from koala_tpu.models import params_io as jio
from koala_tpu.parallel.runner import wash_corpus as jwash_corpus
from koala_tpu_torch.parallel import (CorpusRunner, make_mesh, shard_batch, shard_state,
                                      wash_corpus)

import torch_ref  # noqa: F401  (pins torch to 2 threads)

CPU4 = ["cpu"] * 4


def test_mesh_of_cpu_shards():
    mesh = make_mesh(CPU4)
    assert mesh.size == 4 and mesh.world == 1 and mesh.group is None
    assert mesh.local_rows(8) == (0, 8)
    blocks = shard_batch(mesh, np.arange(8 * 3, dtype=np.float32).reshape(8, 3))
    assert [b.shape for b in blocks] == [(2, 3)] * 4
    assert torch.equal(torch.cat(blocks), torch.arange(24.0).reshape(8, 3))
    with pytest.raises(ValueError):
        mesh.local_rows(6)


def test_shard_state_takes_the_local_rows_of_every_leaf():
    """A one-device mesh of one process holds every row; each leaf comes
    back on the mesh's device with its batch axis whole (numpy leaves
    become tensors)."""
    from koala_tpu_torch.engine.core import make_engine
    from koala_tpu_torch.models.mask_gru import TRAIN_CONFIG

    state = make_engine("mask_gru", TRAIN_CONFIG).init_state((6,), "cpu")
    state["ola"] = torch.arange(6 * 256, dtype=torch.float32).reshape(6, 256)
    state["model"]["floor"] = np.arange(6 * 32, dtype=np.float32).reshape(6, 32)
    mesh = make_mesh(["cpu"])
    assert mesh.local_rows(6) == (0, 6)
    local = shard_state(mesh, state)
    assert set(local) == set(state) and set(local["model"]) == {"h", "floor"}
    assert torch.equal(local["ola"], state["ola"])
    assert torch.equal(local["model"]["floor"], torch.as_tensor(state["model"]["floor"]))
    assert local["model"]["h"].shape == (6, 2, 384)
    assert all(t.device.type == "cpu" for t in (local["ola"], local["input_carry"]))
    with pytest.raises(ValueError):
        shard_state(make_mesh(CPU4), state)


@pytest.mark.parametrize("model", ["mmse_model", "untrained_model"])
def test_corpus_runner_matches_jax_engine(model, request, rng):
    """Four CPU shards, each running sequence_fast on its block, equal
    koala_tpu's unsharded engine.sequence on the whole batch within 1e-5
    (tests/test_parallel.py's tolerance)."""
    path = request.getfixturevalue(model)
    b, t = 8, 6
    samples = t * FRAME_LENGTH
    pcm = (rng.standard_normal((b, samples)) * 0.1).astype(np.float32)

    runner = CorpusRunner(path, global_batch=b, utterance_samples=samples, mesh=make_mesh(CPU4))
    out = runner.enhance_batch(pcm).numpy().reshape(b, samples)

    params, config = jio.load_params(path)
    engine = jmake_engine(config.get("kind", "mask_gru"), config)
    _, ref = engine.sequence(params, engine.init_state((b,)),
                             jnp.asarray(pcm.reshape(b, t, FRAME_LENGTH)))
    np.testing.assert_allclose(out, np.asarray(ref).reshape(b, samples), atol=1e-5)


def test_corpus_runner_checks_its_shapes(mmse_model):
    with pytest.raises(ValueError):
        CorpusRunner(mmse_model, global_batch=6, utterance_samples=1024, mesh=make_mesh(CPU4))
    with pytest.raises(ValueError):
        CorpusRunner(mmse_model, global_batch=8, utterance_samples=1000, mesh=make_mesh(CPU4))


@pytest.mark.parametrize("model", ["mmse_model", "untrained_model"])
def test_wash_corpus_report_matches_jax(model, request, rng):
    path = request.getfixturevalue(model)
    n, samples = 16, 4 * FRAME_LENGTH
    corpus = (rng.standard_normal((n, samples)) * 3000).astype(np.int16)
    report = wash_corpus(path, corpus, mesh=make_mesh(CPU4))
    want = jwash_corpus(path, corpus)
    assert set(report) == set(want)
    assert report["chips"] == 4 and report["batches"] == want["batches"] >= 1
    assert report["audio_seconds"] == want["audio_seconds"] > 0
    assert report["audio_seconds_per_second"] > 0
