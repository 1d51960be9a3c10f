"""The GRU kernel's gate in the port's mask model (models/mask_gru.py): the
kernel branch takes the GRU kernel wherever ``plan_launch`` has a launch
plan, which on an H100 is every stack that koala_tpu's TPU kernel takes
(``gru_stack_supported``), and otherwise runs the scan with one warning, as
koala_tpu does where its TPU kernel does not fit
(koala_tpu/models/mask_gru.py ``_pallas_enabled``)."""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koala_tpu.models import mask_gru as jmask
from koala_tpu.ops import stft as jstft
from koala_tpu.ops.pallas.gru import gru_stack_supported
from koala_tpu_torch.models import mask_gru as tmask
from koala_tpu_torch.models import params_io as tio
from koala_tpu_torch.ops.kernels.gru import H100_SMS

from torch_ref import jax_params, to_numpy

WIDE = dict(jmask.TRAIN_CONFIG, hidden=512, num_layers=3)
# no launch plan on an H100, and too large for koala_tpu's kernel as well
UNPLANNED = dict(jmask.TRAIN_CONFIG, hidden=768, num_layers=3)
RTOL, ATOL = 1e-4, 1e-4          # tests/test_torch_models.py's model tolerance
# The kernel branch against koala_tpu's scan: the kernel streams x as bf16
# between layers, one rounding more than the scan (tests/test_torch_models.py
# test_kernel_branch_matches_scan_branch holds h at 1e-3 for it); 8.0e-4
# measured at 512 x 3, on 1280 of 3072 values past 1e-4.
KERNEL_H_ATOL = 1e-3


@pytest.mark.parametrize("hidden,layers,batch,fits", [
    (512, 3, 64, True), (384, 5, 64, True), (128, 12, 64, True),
    (768, 3, 64, False), (1024, 2, 64, True), (1024, 3, 64, False),
    (384, 2, 1, True), (384, 2, 64, True), (384, 2, 512, True),
])
def test_gru_kernel_fits_follows_the_launch_plan(hidden, layers, batch, fits):
    assert tmask.gru_kernel_fits(batch, hidden, layers, sms=H100_SMS) is fits


# (batch, hidden, layers): the port's gate on an H100 against koala_tpu's
# gru_stack_supported, where the two differ. The TPU gate asks for batch and
# hidden in whole vector tiles (multiples of 8 and 128) and a VMEM budget that
# grows with the batch; the card's asks for a row group's blocks to fit the
# card and a block's share of the weights and operands its registers and
# shared memory, whatever the batch (rows are spread over the grid). The card
# takes every shape that the TPU takes.
GATE_SHAPES = [(b, h, l) for b in (8, 64, 512) for h, l in (
    (384, 2), (384, 3), (384, 4), (512, 2), (512, 3), (384, 5), (128, 12), (768, 2),
    (768, 3), (1024, 2), (1024, 1), (256, 4), (192, 8), (128, 3), (64, 1))]
ONLY_TPU = set()
ONLY_CARD = {(8, 1024, 2), (8, 192, 8), (8, 64, 1), (64, 768, 2), (64, 1024, 2),
             (64, 192, 8), (64, 64, 1), (512, 384, 3), (512, 384, 4), (512, 512, 2),
             (512, 512, 3), (512, 384, 5), (512, 128, 12), (512, 768, 2), (512, 1024, 2),
             (512, 1024, 1), (512, 256, 4), (512, 192, 8), (512, 64, 1)}


def test_gate_against_the_reference_gate():
    for b, h, layers in GATE_SHAPES:
        card = tmask.gru_kernel_fits(b, h, layers, sms=H100_SMS)
        tpu = gru_stack_supported(layers, b, h)
        assert (card and not tpu) == ((b, h, layers) in ONLY_CARD), (b, h, layers)
        assert (tpu and not card) == ((b, h, layers) in ONLY_TPU), (b, h, layers)


@pytest.mark.parametrize("batch", [8, 16, 64, 512])
def test_every_stack_the_reference_kernel_takes_has_a_plan(batch):
    """Every (hidden, layers) that koala_tpu's kernel takes at this batch
    (hidden a multiple of 128 up to 1024 and as many layers as its VMEM
    budget allows, 67 at most) has a launch plan on an H100: the port runs
    the scan only where both gates refuse."""
    taken = [(h, layers) for h in range(128, 1025, 128) for layers in range(1, 80)
             if gru_stack_supported(layers, batch, h)]
    assert len(taken) >= 10
    missing = [s for s in taken if not tmask.gru_kernel_fits(batch, *s, sms=H100_SMS)]
    assert missing == []


def _wide_inputs(b=2, t=8, seed=4):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((b, t, 512)) * 0.1).astype(np.float32)
    re, im = jstft.stft_frame(jnp.asarray(frames))
    return np.array(re), np.array(im)


@pytest.fixture
def gru_calls(monkeypatch):
    """Counts the model's calls of the GRU wrappers (their plain versions on
    the CPU) and forgets earlier warnings, so that each test sees its own."""
    calls = []
    for name in ("gru_stack", "gru_stack_trainable"):
        orig = getattr(tmask, name)

        def counted(*args, _orig=orig, _name=name, **kwargs):
            calls.append(_name)
            return _orig(*args, **kwargs)
        monkeypatch.setattr(tmask, name, counted)
    monkeypatch.setattr(tmask, "_FALLBACK_WARNED", set())
    return calls


def _disabled_warnings(caplog):
    return [r for r in caplog.records if "GRU kernel DISABLED" in r.getMessage()]


def _held_against_jax(cfg, seed, h_atol):
    """The port's apply_sequence (use_pallas=True, twice) against koala_tpu's
    on the same seeded weights and inputs at B = 2, T = 8 (where koala_tpu's
    gate refuses its kernel and runs its scan): the mask and the floor
    within tests/test_torch_models.py's tolerance (rtol 1e-4, atol 1e-4), h
    within ``h_atol``."""
    cfg = dict(cfg, use_pallas=True)
    tree = jax_params(cfg, seed)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tio.params_from_numpy(tree, "cpu")
    re, im = _wide_inputs()
    j_state, j_mask = jmask.apply_sequence(jp, jmask.init_state((2,), cfg),
                                           jnp.asarray(re), jnp.asarray(im), cfg)
    for _ in range(2):
        t_state, t_mask = tmask.apply_sequence(
            tp, tmask.init_state((2,), cfg, "cpu"), torch.as_tensor(re),
            torch.as_tensor(im), cfg)
    np.testing.assert_allclose(t_mask.numpy(), np.asarray(j_mask), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_state["floor"].numpy(), np.asarray(j_state["floor"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_numpy(t_state["h"]), np.asarray(j_state["h"]),
                               rtol=RTOL, atol=h_atol)


def test_wide_model_takes_the_scan_and_matches_jax(gru_calls, caplog):
    """hidden 768 x 3 layers has no launch plan (nor a place in koala_tpu's
    kernel): with use_pallas=True the port warns once and runs the scan
    branch, and matches koala_tpu, h within ATOL too (7.6e-5 measured)."""
    with caplog.at_level(logging.WARNING, logger="koala_tpu_torch"):
        _held_against_jax(UNPLANNED, 7, ATOL)
    assert gru_calls == []
    warned = _disabled_warnings(caplog)
    assert len(warned) == 1 and "no GRU kernel launch plan" in warned[0].getMessage()


def test_wide_model_takes_the_kernel_and_matches_jax(gru_calls, caplog):
    """hidden 512 x 3 layers has a launch plan (two layer groups on an
    H100): the port takes the kernel branch (the GRU wrapper's plain version
    here), warns nothing, and matches koala_tpu, h within KERNEL_H_ATOL."""
    with caplog.at_level(logging.WARNING, logger="koala_tpu_torch"):
        _held_against_jax(WIDE, 7, KERNEL_H_ATOL)
    assert gru_calls == ["gru_stack", "gru_stack"]
    assert _disabled_warnings(caplog) == []


def test_wide_model_trains_through_the_scan(gru_calls, caplog):
    """The scan branch carries autograd: a loss over a model without a
    launch plan (768 x 3) has a finite gradient on every GRU layer, and no
    GRU wrapper is called."""
    cfg = dict(UNPLANNED, use_pallas=True)
    params = tmask.init_params(torch.Generator().manual_seed(1), cfg).requires_grad_(True)
    re, im = (torch.as_tensor(a) for a in _wide_inputs(seed=5))
    with caplog.at_level(logging.WARNING, logger="koala_tpu_torch"):
        _, mask = tmask.apply_sequence(params, tmask.init_state((2,), cfg, "cpu"), re, im,
                                       cfg)
    mask.square().mean().backward()
    assert gru_calls == [] and len(_disabled_warnings(caplog)) == 1
    for layer in params.gru:
        assert torch.isfinite(layer.wh.grad).all() and layer.wh.grad.abs().sum() > 0


@pytest.mark.parametrize("train", [False, True])
def test_planned_model_keeps_the_kernel_branch(gru_calls, caplog, train):
    """hidden 384 x 2 layers has a plan: the kernel branch calls the GRU
    wrapper (its plain version here) and warns nothing."""
    cfg = dict(jmask.TRAIN_CONFIG, use_pallas=True)
    params = tmask.init_params(torch.Generator().manual_seed(2), cfg).requires_grad_(train)
    re, im = (torch.as_tensor(a) for a in _wide_inputs(seed=6))
    with caplog.at_level(logging.WARNING, logger="koala_tpu_torch"):
        tmask.apply_sequence(params, tmask.init_state((2,), cfg, "cpu"), re, im, cfg)
    assert gru_calls == ["gru_stack_trainable" if train else "gru_stack"]
    assert _disabled_warnings(caplog) == []


@pytest.mark.parametrize("train", [False, True])
def test_wide_model_keeps_the_kernel_branch(gru_calls, caplog, train):
    """hidden 512 x 3 layers has a plan too: training calls the
    differentiable wrapper, whose gradient reaches every layer."""
    cfg = dict(WIDE, use_pallas=True)
    params = tmask.init_params(torch.Generator().manual_seed(3), cfg).requires_grad_(train)
    re, im = (torch.as_tensor(a) for a in _wide_inputs(seed=8))
    with caplog.at_level(logging.WARNING, logger="koala_tpu_torch"):
        _, mask = tmask.apply_sequence(params, tmask.init_state((2,), cfg, "cpu"), re, im,
                                       cfg)
    assert gru_calls == ["gru_stack_trainable" if train else "gru_stack"]
    assert _disabled_warnings(caplog) == []
    if train:
        mask.square().mean().backward()
        for layer in params.gru:
            assert torch.isfinite(layer.wh.grad).all() and layer.wh.grad.abs().sum() > 0
