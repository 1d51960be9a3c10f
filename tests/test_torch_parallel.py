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


def test_corpus_runner_records_its_spans(mmse_model, rng):
    """Under a profiler one batch records ``runner.issue`` holding
    ``runner.upload`` (its bytes, all pageable from a numpy batch, none
    staged through the page-locked ring on the CPU) and
    ``runner.launch``, which holds ``engine.sequence`` and, in it,
    ``engine.model`` and the mmse model's ``mmse.gain``; every span carries
    the batch's number."""
    import time

    from koala_tpu_torch import profiling

    b, t = 4, 6
    pcm = (rng.standard_normal((b, t * FRAME_LENGTH)) * 0.1).astype(np.float32)
    runner = CorpusRunner(mmse_model, global_batch=b, utterance_samples=t * FRAME_LENGTH,
                          mesh=make_mesh(["cpu"]))
    runner.enhance_batch(pcm)                   # unprofiled: records nothing
    t0 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        runner.enhance_batch(pcm)
    spans = {s.name: s for s in profiling.spans(t0, time.time_ns())}
    assert set(spans) == {"runner.issue", "runner.upload", "runner.launch",
                          "engine.sequence", "engine.model", "mmse.gain"}
    for inner, outer in (("runner.upload", "runner.issue"), ("runner.launch", "runner.issue"),
                         ("engine.sequence", "runner.launch"),
                         ("engine.model", "engine.sequence"), ("mmse.gain", "engine.model")):
        s, o = spans[inner], spans[outer]
        assert s.parent == outer and o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns
    assert spans["runner.upload"].end_ns <= spans["runner.launch"].start_ns
    assert spans["runner.upload"].counts == {"bytes": b * t * FRAME_LENGTH * 4,
                                             "pageable_bytes": b * t * FRAME_LENGTH * 4,
                                             "staged_bytes": 0, "ring_waits": 0}
    assert spans["engine.sequence"].counts == {"hops": t}
    assert spans["engine.model"].counts == {"frames": t}
    assert spans["mmse.gain"].counts == {"frames": t, "columns": b * 257, "kernel": 0}
    assert {s.batch for s in spans.values()} == {2} and runner.batch_number == 2


@pytest.mark.parametrize("model", ["mmse_model", "untrained_model"])
def test_cpu_mesh_upload_is_a_plain_copy(model, request, rng):
    """A CPU mesh's runner takes its blocks by ``.to()``: no copy stream, no
    input buffers, no ring, ``staged_bytes`` 0; batches A, B, A each equal
    ``Engine.sequence_fast`` run alone on each device's block."""
    import time

    from koala_tpu_torch import profiling
    from koala_tpu_torch.engine.core import make_engine
    from koala_tpu_torch.models import params_io

    path = request.getfixturevalue(model)
    b, t = 8, 6
    a, c = ((rng.standard_normal((b, t * FRAME_LENGTH)) * 0.1).astype(np.float32)
            for _ in range(2))
    runner = CorpusRunner(path, global_batch=b, utterance_samples=t * FRAME_LENGTH,
                          mesh=make_mesh(CPU4))
    assert runner.uploader.lanes == [None] * 4
    t0 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = [runner.enhance_batch(x) for x in (a, c, a)]
    ups = [s for s in profiling.spans(t0, time.time_ns()) if s.name == "runner.upload"]
    assert [s.counts["staged_bytes"] for s in ups] == [0, 0, 0]
    assert runner.uploader.ring == []

    tree, config = params_io.load_params(path)
    kind = config.get("kind", "mask_gru")
    engine = make_engine(kind, config)
    params = params_io.params_from_numpy(tree, "cpu", kind)
    for x, out in zip((a, c, a), outs):
        blocks = torch.from_numpy(x.reshape(b, t, FRAME_LENGTH)).split(b // 4)
        want = torch.cat([engine.sequence_fast(params, engine.init_state((2,), "cpu"), blk)[1]
                          for blk in blocks])
        assert torch.equal(out, want)
