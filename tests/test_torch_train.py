"""Trainer of the port (koala_tpu_torch/train) against the JAX package's, on
the CPU at a small size: loss terms, loss and gradients, the optimizer and its
schedule, the evaluation harness, and a trained model crossing packages."""

import importlib
import importlib.util
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import koala_tpu
import koala_tpu_torch
from koala_tpu.models import mask_gru as jmask
from koala_tpu.models import params_io as jparams_io
from koala_tpu.train import evaluate as jevaluate
from koala_tpu.train import fwsnrseg as jfwsnrseg
from koala_tpu.train import pseudo_real as jpseudo
from koala_tpu.train import stoi as jstoi
from koala_tpu.train.data import MixtureSampler
from koala_tpu_torch import KoalaInvalidArgumentError
from koala_tpu_torch.io import read_wav
from koala_tpu_torch.models import mask_gru as tmask
from koala_tpu_torch.models import params_io as tparams_io
from koala_tpu_torch.train import evaluate as tevaluate
from koala_tpu_torch.train import fwsnrseg as tfwsnrseg
from koala_tpu_torch.train import pseudo_real as tpseudo
from koala_tpu_torch.train import stoi as tstoi

from torch_ref import ACCESS_KEY, assert_evaluate_near_jax, flat_tree, jax_params, rel_err

# the packages re-export the function ``train`` under the submodule's name
jtrain = importlib.import_module("koala_tpu.train.train")
ttrain = importlib.import_module("koala_tpu_torch.train.train")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(ROOT, "resources", "audio_samples")
SMALL = dict(jmask.TRAIN_CONFIG, hidden=128)      # TRAIN_CONFIG narrowed to H = 128
B, FRAMES = 8, 12


@pytest.fixture(scope="module")
def banks():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 20000)
    speech = [(np.sin(700 * np.pi * t) * np.sin(13 * np.pi * t) * 0.3).astype(np.float32)]
    noise = [rng.standard_normal(20000).astype(np.float32) * 0.05]
    return speech, noise


@pytest.fixture(scope="module")
def batch(banks):
    return MixtureSampler(*banks, segment_frames=FRAMES, seed=1).sample(B)


def _jax_loss_and_grads(cfg, tree, noisy, clean):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    loss, grads = jax.value_and_grad(jtrain.make_loss_fn(cfg))(
        params, jnp.asarray(noisy), jnp.asarray(clean))
    return float(loss), flat_tree(grads)


def _torch_loss_and_grads(cfg, tree, noisy, clean):
    params = tparams_io.params_from_numpy(tree, "cpu").requires_grad_(True)
    loss = ttrain.make_loss_fn(cfg)(params, torch.as_tensor(noisy), torch.as_tensor(clean))
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy() for n, p in params.named_parameters()}


# (dtype, use_pallas in the port, loss rtol, gradient relative error per leaf).
# float32: the two differ only in summation order; measured 1e-7 on the loss,
# <= 5e-5 on every weight matrix and 1.1e-4 on the scalar gate.b (one number
# summed over every frame, with cancellation). bfloat16: every product rounds its operands and
# every cotangent that crosses one; the frameworks round at the same places
# but not on identical sums; measured <= 1.5e-3 (scan branch) and <= 3.2e-3
# (kernel branch through the plain versions, whose residual stream is bf16).
LOSS_CASES = [
    ("float32", False, 1e-5, 3e-4),
    ("bfloat16", False, 1e-4, 5e-3),
    ("bfloat16", True, 1e-4, 1e-2),
]


@pytest.mark.parametrize("dtype,use_pallas,loss_rtol,grad_tol", LOSS_CASES)
def test_loss_and_gradients_match_jax(batch, dtype, use_pallas, loss_rtol, grad_tol):
    noisy, clean = batch
    cfg = dict(SMALL, compute_dtype=dtype)
    tree = jax_params(cfg, 3)
    jl, jg = _jax_loss_and_grads(cfg, tree, noisy, clean)      # the JAX scan branch
    tl, tg = _torch_loss_and_grads(dict(cfg, use_pallas=use_pallas), tree, noisy, clean)
    assert abs(tl - jl) <= loss_rtol * abs(jl)
    assert set(tg) == set(jg)
    for name in jg:
        assert rel_err(jg[name], tg[name]) < grad_tol, name


def _pair(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    b = (a * 0.7 + rng.standard_normal(shape) * scale * 0.3).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["snr_loss", "frame_rms_l1", "spectral_l1"])
def test_loss_terms_match_jax(name):
    """Each term on seeded waveforms: rtol 1e-5 (float32 sums in another
    order), value and gradient with respect to the estimate."""
    est, ref = _pair(5, (4, 32 * 256))
    ref[1] = 0.0                                   # a silent target
    jfn, tfn = getattr(jtrain, name), getattr(ttrain, name)
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(est), jnp.asarray(ref))
    e = torch.as_tensor(est).requires_grad_(True)
    tv = tfn(e, torch.as_tensor(ref))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    assert rel_err(np.asarray(jg), e.grad.numpy()) < 1e-4


def test_delayed_matches_jax():
    x = np.arange(1000, dtype=np.float32)[None, :]
    np.testing.assert_array_equal(ttrain.delayed(torch.as_tensor(x)).numpy(),
                                  np.asarray(jtrain.delayed(jnp.asarray(x))))


def test_schedule_matches_optax_at_every_step():
    """200-step run: the schedule function and the learning rate the
    optimizer really applies, against optax's, rtol 1e-5 (optax evaluates it
    in float32; measured 1.8e-6)."""
    steps, lr = 200, 3e-4
    want = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.05, peak_value=lr, warmup_steps=max(steps // 20, 10),
        decay_steps=steps, end_value=lr * 0.02)
    schedule = ttrain.warmup_cosine_schedule(lr, steps)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = ttrain.ClippedAdamW([p], schedule)
    for i in range(steps + 5):
        np.testing.assert_allclose(schedule(i), float(want(i)), rtol=1e-5)
        np.testing.assert_allclose(opt.adamw.param_groups[0]["lr"], float(want(i)), rtol=1e-5)
        p.grad = torch.ones(3)
        opt.step()


def test_clip_is_the_optax_formula():
    """g * max_norm / norm where norm > max_norm, no epsilon on the norm."""
    g = np.array([3.0, 4.0], np.float32)
    want, _ = optax.clip_by_global_norm(1.0).update({"g": jnp.asarray(g)}, optax.EmptyState())
    p = torch.nn.Parameter(torch.zeros(2))
    opt = ttrain.ClippedAdamW([p], lambda i: 0.0)
    p.grad = torch.as_tensor(g.copy())
    opt.step()
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(want["g"]))
    p.grad = torch.as_tensor(g.copy() * 0.1)           # norm 0.5: untouched
    opt.step()
    np.testing.assert_array_equal(p.grad.numpy(), g * np.float32(0.1))


def test_five_optimizer_steps_track_optax(banks):
    """From the same float32 weights and batches, five updates of the port
    (ClippedAdamW + schedule) against five of the JAX train step with
    optax.chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay=1e-5))."""
    steps, lr = 100, 3e-4
    cfg = dict(SMALL, compute_dtype="float32")
    tree = jax_params(cfg, 4)
    sampler = MixtureSampler(*banks, segment_frames=FRAMES, seed=2)
    batches = [sampler.sample(B) for _ in range(5)]

    schedule = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.05, peak_value=lr, warmup_steps=max(steps // 20, 10),
        decay_steps=steps, end_value=lr * 0.02)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adamw(schedule, weight_decay=1e-5))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = optimizer.init(jp)
    jstep = jtrain.make_train_step(cfg, optimizer)
    jlosses = []
    for noisy, clean in batches:
        jp, jstate, loss = jstep(jp, jstate, jnp.asarray(noisy), jnp.asarray(clean))
        jlosses.append(float(loss))

    tp = tparams_io.params_from_numpy(tree, "cpu").requires_grad_(True)
    tstep = ttrain.make_train_step(cfg, ttrain.make_optimizer(tp, lr, steps))
    tlosses = [float(tstep(tp, torch.as_tensor(n), torch.as_tensor(c))) for n, c in batches]

    # the loss is a sum of terms of both signs: measured 1.9e-5 where it is
    # small (5.8) beside its terms
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    start, want = flat_tree(tree), flat_tree(jp)
    for name, p in tp.named_parameters():
        got = p.detach().numpy()
        # Adam's update is about lr per element per step whatever the
        # gradient's size, so the five updates (about 1e-4 in all) are held
        # to 2% of their norm, and every single weight to 2e-5 absolute, a
        # fifth of its total update (measured up to 7.9e-6 on a handful of
        # elements whose gradient is near zero, where Adam's division by
        # sqrt(v) magnifies the float32 difference).
        assert rel_err(want[name] - start[name], got - start[name]) < 2e-2, name
        np.testing.assert_allclose(got, want[name], atol=2e-5, rtol=0)
        assert np.any(got != start[name]), name


def test_short_training_improves_loss(banks):
    """The analog of tests/test_train.py: ten updates on one fixed batch
    lower the loss (kernel branch through the plain versions)."""
    cfg = dict(SMALL, use_pallas=True)
    gen = torch.Generator().manual_seed(0)
    params = tmask.init_params(gen, cfg).requires_grad_(True)
    step = ttrain.make_train_step(cfg, torch.optim.Adam(params.parameters(), lr=1e-3))
    noisy, clean = MixtureSampler(*banks, segment_frames=8, seed=2).sample(8)
    noisy, clean = torch.as_tensor(noisy), torch.as_tensor(clean)
    losses = [float(step(params, noisy, clean)) for _ in range(10)]
    assert losses[-1] < losses[0]


def test_training_after_serving_in_inference_mode(batch):
    """Constants and derived weights cached by a serving call (made under
    torch.inference_mode) must not poison a graph recorded afterwards."""
    from koala_tpu_torch.engine.core import make_engine
    from koala_tpu_torch.ops import stft as tstft

    tstft._bases_on.cache_clear()
    tmask._constant_on.cache_clear()
    noisy, clean = (torch.as_tensor(a) for a in batch)
    params = tmask.init_params(torch.Generator().manual_seed(2), SMALL)
    engine = make_engine("mask_gru", SMALL)
    with torch.inference_mode():
        engine.sequence(params, engine.init_state((B,), "cpu"), noisy.reshape(B, FRAMES, 256))
    params.requires_grad_(True)
    with torch.no_grad():                       # evaluation between training steps
        wx = params.gru_stacked()[0]
    assert not wx.requires_grad                 # the cached operands carry no graph
    params.requires_grad_(False)
    params.enc.requires_grad_(True)             # the rest stays frozen (cached roundings)
    loss = ttrain.make_loss_fn(SMALL)(params, noisy, clean)
    loss.backward()
    assert torch.isfinite(params.enc.w.grad).all() and params.dec.w.grad is None


def test_init_params_layout_and_statistics():
    gen = torch.Generator().manual_seed(5)
    params = tmask.init_params(gen, SMALL)
    want = flat_tree(jax_params(SMALL, 0))
    got = {n: p for n, p in params.named_parameters()}
    assert {n: tuple(p.shape) for n, p in got.items()} == \
        {n: v.shape for n, v in want.items()}
    assert not any(p.requires_grad for p in got.values())
    for name in ("enc.w", "gru.0.wx", "gru.1.wh", "dec.w"):
        bound = 1.0 / np.sqrt(got[name].shape[0])
        w = got[name].numpy()
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
        # uniform on +-bound: std bound / sqrt(3), within 5% at these sizes
        assert abs(w.std() - bound / np.sqrt(3)) < 0.05 * bound
    assert torch.all(got["dec.b"] == 3.0) and torch.all(got["gate.b"] == -2.0)
    assert torch.all(got["gate.w"] == 0) and torch.all(got["gru.0.bx"] == 0)
    again = tmask.init_params(torch.Generator().manual_seed(5), SMALL)
    assert torch.equal(again.enc.w, params.enc.w)


def test_params_to_numpy_inverts_params_from_numpy():
    tree = jax_params(SMALL, 6)
    back = tparams_io.params_to_numpy(tparams_io.params_from_numpy(tree, "cpu"))
    want, got = flat_tree(tree), flat_tree(back)
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_mesh_path_raises_typed_error():
    """A mesh argument that is not a parallel.Mesh of one device a process
    is refused with the typed error."""
    from koala_tpu_torch.parallel import make_mesh

    with pytest.raises(KoalaInvalidArgumentError):
        ttrain.make_train_step(SMALL, None, mesh=object())
    with pytest.raises(KoalaInvalidArgumentError):
        ttrain.make_train_step(SMALL, None, mesh=make_mesh(["cpu", "cpu"]))


def test_data_parallel_step_matches_one_process(batch, tmp_path):
    """Two gloo processes, each on its half of the global batch, against the
    one-process step on the whole batch: the loss within rtol 1e-4 and the
    averaged gradients within max|d| / max(|g|, 1e-3) < 1e-2
    (tests/test_train.py's sharded-step tolerances), and the parameters
    bit-identical across the processes after two steps."""
    import torch.multiprocessing as tmp

    from torch_ref import RecordingOptimizer, data_parallel_worker, free_port

    noisy, clean = batch
    tree = jax_params(SMALL, 11)
    params = tparams_io.params_from_numpy(tree, "cpu").requires_grad_(True)
    opt = RecordingOptimizer(ttrain.make_optimizer(params, 1e-3, 10))
    loss = float(ttrain.make_train_step(SMALL, opt)(params, torch.as_tensor(noisy),
                                                  torch.as_tensor(clean)))
    want = {n: g.numpy() for (n, _), g in zip(params.named_parameters(), opt.grads[0])}

    ctx = tmp.get_context("spawn")
    out = str(tmp_path / "rank%d.npz")
    port = free_port()
    procs = [ctx.Process(target=data_parallel_worker, daemon=True,
                         args=(r, 2, port, tree, SMALL, noisy, clean, 2, out)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + 120
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]

    ranks = [np.load(out % r) for r in range(2)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"][0], loss, rtol=1e-4)
        for name, g in want.items():
            assert np.max(np.abs(r["grad/" + name] - g)) / max(np.abs(g).max(), 1e-3) < 1e-2, name
    names = [k for k in ranks[0].files if k != "losses"]
    for k in names + ["losses"]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_train_with_a_one_process_mesh_is_the_plain_trainer(banks):
    """train(..., mesh=...) with one process and one CPU device: the step
    takes all rows and the reduction divides by one, so the weights equal
    those of train(device="cpu") bit for bit."""
    from koala_tpu_torch.parallel import make_mesh

    speech, noise = banks
    kw = dict(steps=2, batch=4, segment_frames=4, config=SMALL, log_every=0, seed=5)
    a, _ = ttrain.train(speech, noise, device="cpu", **kw)
    b, _ = ttrain.train(speech, noise, mesh=make_mesh(["cpu"]), **kw)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("entry", ["train", "train_on_device"])
def test_trainers_need_a_card_unless_cpu_is_asked(entry, banks, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    speech, noise = banks
    args = (speech, noise) if entry == "train" else (speech[0], noise[0])
    with pytest.raises(KoalaInvalidArgumentError):
        getattr(ttrain, entry)(*args, steps=1, batch=2, segment_frames=4, config=SMALL)


def test_train_on_device_ema_is_debiased_and_apart(banks, capsys):
    """Three steps on the CPU: finite weights, the log lines, and an EMA that
    is the debiased average of the iterates, not the last iterate."""
    speech, noise = banks
    params, cfg = ttrain.train_on_device(
        speech[0], noise[0], steps=3, batch=4, segment_frames=6, config=SMALL,
        log_every=1, device="cpu", seed=3)
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "WARNING: steps=3 is short" in out
    assert cfg["hidden"] == 128 and isinstance(params, tmask.MaskGRU)
    fresh = tmask.init_params(torch.Generator().manual_seed(3), SMALL)
    for (name, p), q in zip(params.named_parameters(), fresh.parameters()):
        assert torch.isfinite(p).all() and not p.requires_grad
        # a debiased average of three nearby iterates stays near the start
        assert (p - q).abs().max() < 1e-2, name
    assert not torch.equal(params.enc.w, fresh.enc.w)


def test_trained_model_crosses_packages(banks, tmp_path):
    """Three steps with the host sampler, saved by the port: the file loads
    in both packages and both enhance the same audio within 2 int16 LSB."""
    speech, noise = banks
    params, cfg = ttrain.train(speech, noise, steps=3, batch=4, segment_frames=6,
                               config=SMALL, log_every=0, device="cpu", seed=1)
    path = str(tmp_path / "trained.pv")
    tparams_io.save_params(path, params, cfg)
    jtree, jcfg = jparams_io.load_params(path)
    assert jcfg["hidden"] == 128 and jcfg["snr_bands"] == 32
    ttree, _ = tparams_io.load_params(path)
    for name, v in flat_tree(jtree).items():
        np.testing.assert_array_equal(flat_tree(ttree)[name], v)

    sp = read_wav(os.path.join(AUDIO, "speech_synth.wav")).astype(np.int32)
    no = read_wav(os.path.join(AUDIO, "noise_synth.wav")).astype(np.int32)
    n = 100 * 256
    mix = np.clip(sp[:n] + no[:n], -32768, 32767).astype(np.int16)
    t = koala_tpu_torch.create(ACCESS_KEY, model_path=path, device="cpu")
    j = koala_tpu.create(ACCESS_KEY, model_path=path, device="cpu")
    a, b = t.enhance(mix), j.enhance(mix)
    t.delete()
    j.delete()
    assert a.shape == mix.shape and np.any(a != 0)
    assert int(np.max(np.abs(a.astype(np.int32) - b.astype(np.int32)))) <= 2


@pytest.fixture(scope="module")
def fixtures():
    return (read_wav(os.path.join(AUDIO, "speech_synth.wav")),
            read_wav(os.path.join(AUDIO, "noise_synth.wav")))


def test_evaluate_matches_jax(fixtures):
    """The bundled model on the synth fixture pair through both harnesses,
    within ``torch_ref.EVALUATE_TOL``."""
    speech, noise = fixtures
    n = 150 * 256                                   # 2.4 s keeps the scan short
    speech, noise = speech[:n], noise[:n]
    tree, cfg = tparams_io.load_params(tparams_io.default_model_path())
    want = jevaluate.evaluate(jax.tree_util.tree_map(jnp.asarray, tree), cfg, speech, noise)
    got = tevaluate.evaluate(tree, cfg, speech, noise, device="cpu")
    assert_evaluate_near_jax(got, want)


def test_evaluate_needs_a_card_unless_cpu_is_asked(fixtures, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    speech, noise = fixtures
    tree, cfg = tparams_io.load_params(tparams_io.default_model_path())
    with pytest.raises(KoalaInvalidArgumentError):
        tevaluate.evaluate(tree, cfg, speech[:2560], noise[:2560])


def test_metric_copies_are_bit_identical(fixtures):
    speech, noise = fixtures
    n = 40000
    mixed = np.clip(speech[:n].astype(np.int32) + noise[:n], -32768, 32767).astype(np.int16)
    assert tstoi.stoi(speech[:n], mixed) == jstoi.stoi(speech[:n], mixed)
    assert tfwsnrseg.fwsnrseg(speech[:n], mixed) == jfwsnrseg.fwsnrseg(speech[:n], mixed)
    assert tevaluate.rms_case(mixed, speech[:n]) == jevaluate.rms_case(mixed, speech[:n])
    assert tevaluate.si_sdr(mixed, speech[:n]) == jevaluate.si_sdr(mixed, speech[:n])


def test_pseudo_real_copy_is_bit_identical(fixtures):
    speech, noise = fixtures
    want = jpseudo.variants(speech[:30000], noise[:30000])
    got = tpseudo.variants(speech[:30000], noise[:30000])
    assert list(got) == list(want)
    for case in want:
        for a, b in zip(got[case], want[case]):
            np.testing.assert_array_equal(a, b)


def _script(name):
    """A training script of the repository loaded by path as a module."""
    spec = importlib.util.spec_from_file_location(
        "_script_" + name, os.path.join(ROOT, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


WAV_PAIR = (os.path.join(AUDIO, "speech_dev.wav"), os.path.join(AUDIO, "noise_dev.wav"))


def test_wav_tapes_match_the_jax_script():
    """--speech/--noise tapes: scripts/train_model_torch.py's build_wav_tapes
    equals scripts/train_model.py's bit for bit (speed perturbation, colored
    noise from default_rng(7))."""
    want = _script("train_model").build_wav_tapes([WAV_PAIR[0]], [WAV_PAIR[1]])
    got = _script("train_model_torch").build_wav_tapes([WAV_PAIR[0]], [WAV_PAIR[1]])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_wav_tape_mode_trains(tmp_path, monkeypatch, capsys):
    """The script's WAV-tape mode takes a train step on the CPU from the two
    files (no corpus is built) and writes a model file that loads."""
    script = _script("train_model_torch")

    def no_corpus(*args):
        raise AssertionError("the WAV-tape mode built corpus tapes")
    monkeypatch.setattr(script, "build_corpus_tapes", no_corpus)
    monkeypatch.setattr(script, "eval_all", lambda params, cfg, reference=None: {})
    out = str(tmp_path / "wav.pv")
    script.main(["--cpu", "--steps", "1", "--batch", "2", "--segment-frames", "8",
                 "--speech", WAV_PAIR[0], "--noise", WAV_PAIR[1], "--out", out])
    speech, noise = script.build_wav_tapes([WAV_PAIR[0]], [WAV_PAIR[1]])
    assert ("tapes: speech %.1f s, noise %.1f s" % (len(speech) / 16000.0, len(noise) / 16000.0)
            in capsys.readouterr().out)
    tree, cfg = tparams_io.load_params(out)
    assert cfg["snr_bands"] == 32 and np.isfinite(tree["enc"]["w"]).all()
