"""Kernels of koala_tpu_torch on a CUDA card, each against its plain version,
and the public surface's launches. Marked ``cuda``: they skip where there is
no card. This file imports neither jax nor koala_tpu, so it also runs on a
machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import koala_tpu_torch
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models import mask_gru, params_io
from koala_tpu_torch.ops.kernels import engine_fused, floor, gru

from torch_ref import ACCESS_KEY, cuda_device, snr_db  # noqa: F401  (fixture)

# bf16 tolerance of the GRU kernel against its plain version: the tensor
# cores sum in another order, and one flipped bf16 rounding of the streamed
# x feeds the recurrence (tests/test_pallas_gru.py's atol).
GRU_ATOL = 4e-2


@pytest.fixture(scope="module")
def bundled():
    tree, cfg = params_io.load_params(params_io.default_model_path())
    return tree, cfg


def _randn(seed, shape, scale, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32),
                           device=device)


@pytest.mark.cuda
def test_floor_kernel_bit_identical(cuda_device):
    lb = _randn(0, (40, 37, 32), 3.0, cuda_device)
    f0 = torch.full((37, 32), 30.0, device=cuda_device)
    before = floor.launches
    kf, kfl = floor.floor_scan(f0, lb, 0.012)
    rf, rfl = floor.floor_scan_ref(f0, lb, 0.012)
    torch.cuda.synchronize()
    assert floor.launches == before + 1
    assert torch.equal(kfl, rfl) and torch.equal(kf, rf)


@pytest.mark.cuda
def test_gru_kernel_matches_plain(cuda_device, bundled):
    """B = 40 spans three 16-row tiles, the last one ragged."""
    params = params_io.params_from_numpy(bundled[0], cuda_device)
    wx, bx, wh, bh = params.gru_stacked()
    x = _randn(1, (24, 40, 384), 0.3, cuda_device).bfloat16()
    h0 = _randn(2, (2, 40, 384), 0.2, cuda_device)
    before = gru.launches
    y, hf = gru.gru_stack(h0, x, wx, bx, wh, bh)
    yr, hr = gru.gru_stack_ref(h0, x, wx, bx, wh, bh)
    torch.cuda.synchronize()
    assert gru.launches == before + 1
    assert (y.float() - yr.float()).abs().max().item() <= GRU_ATOL
    assert (hf - hr).abs().max().item() <= GRU_ATOL


@pytest.mark.cuda
def test_gru_hidden_kernel_matches_plain(cuda_device, bundled):
    """The training variant at a ragged B = 40: y and h_final bit-identical
    to the inference variant's, hs within the GRU tolerance of the plain
    version and ending in h_final."""
    params = params_io.params_from_numpy(bundled[0], cuda_device)
    wx, bx, wh, bh = params.gru_stacked()
    x = _randn(1, (24, 40, 384), 0.3, cuda_device).bfloat16()
    h0 = _randn(2, (2, 40, 384), 0.2, cuda_device)
    y0, hf0 = gru.gru_stack(h0, x, wx, bx, wh, bh)
    before = (gru.launches, gru.launches_hs)
    y, hs, hf = gru.gru_stack(h0, x, wx, bx, wh, bh, return_hidden=True)
    _, hsr, _ = gru.gru_stack_ref(h0, x, wx, bx, wh, bh, return_hidden=True)
    torch.cuda.synchronize()
    assert (gru.launches, gru.launches_hs) == (before[0], before[1] + 1)
    assert hs.shape == (24, 2, 40, 384)
    assert torch.equal(y, y0) and torch.equal(hf, hf0) and torch.equal(hs[-1], hf)
    assert (hs - hsr).abs().max().item() <= GRU_ATOL


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One loss and backward pass of the trainer at full width (B = 16,
    T = 24) on the card (kernel forward, plain backward) against the port on
    the CPU (scan branch): loss within 1e-3 relative, every leaf's gradient
    at cosine >= 0.99 (bf16 sums in another order on the two devices)."""
    from koala_tpu_torch.train.train import make_loss_fn

    cfg = dict(mask_gru.TRAIN_CONFIG)
    gen = torch.Generator().manual_seed(0)
    cpu_params = mask_gru.init_params(gen, cfg).requires_grad_(True)
    card_params = params_io.params_from_numpy(
        params_io.params_to_numpy(cpu_params), cuda_device).requires_grad_(True)
    rng = np.random.default_rng(5)
    t = np.arange(24 * 256) / 16000.0
    clean = np.stack([0.2 * np.sin(2 * np.pi * (200 + 30 * i) * t) * (1 + np.sin(9 * t))
                      for i in range(16)]).astype(np.float32)
    noisy = (clean + rng.standard_normal(clean.shape) * 0.03).astype(np.float32)
    loss_fn = make_loss_fn(cfg)
    before = (gru.launches_hs, floor.launches, engine_fused.launches)
    card = loss_fn(card_params, torch.as_tensor(noisy, device=cuda_device),
                   torch.as_tensor(clean, device=cuda_device))
    card.backward()
    torch.cuda.synchronize()
    assert (gru.launches_hs - before[0], floor.launches - before[1],
            engine_fused.launches - before[2]) == (1, 1, 0)
    cpu = loss_fn(cpu_params, torch.as_tensor(noisy), torch.as_tensor(clean))
    cpu.backward()
    assert abs(card.item() - cpu.item()) <= 1e-3 * abs(cpu.item())
    for (name, a), b in zip(card_params.named_parameters(), cpu_params.parameters()):
        ga, gb = a.grad.cpu().double().ravel(), b.grad.double().ravel()
        assert torch.dot(ga, gb) / (ga.norm() * gb.norm()) >= 0.99, name


@pytest.mark.cuda
def test_fused_kernel_matches_plain(cuda_device, bundled):
    """B = 40: >= 40 dB against the plain version; chunked equals continuous
    bit for bit."""
    tree, cfg = bundled
    params = params_io.params_from_numpy(tree, cuda_device)
    hops = _randn(3, (40, 24, 256), 0.05, cuda_device)
    state = make_engine("mask_gru", cfg).init_state((40,), cuda_device)
    before = engine_fused.launches
    st, out = engine_fused.fused_sequence(params, state, hops, cfg)
    _, ref = engine_fused.fused_sequence_ref(params, state, hops, cfg)
    st_a, a = engine_fused.fused_sequence(params, state, hops[:, :8], cfg)
    _, b = engine_fused.fused_sequence(params, st_a, hops[:, 8:], cfg)
    torch.cuda.synchronize()
    assert engine_fused.launches == before + 3
    assert snr_db(ref.cpu().numpy(), out.cpu().numpy()) >= 40.0
    assert torch.equal(torch.cat([a, b], dim=1), out)


@pytest.mark.cuda
def test_fused_gate_shared_memory(cuda_device, bundled):
    """The bundled model's block fits the card's shared memory; twelve
    layers of hidden state do not."""
    cfg = bundled[1]
    assert engine_fused.fused_sequence_supported(cfg, 64, 376, cuda_device)
    assert not engine_fused.fused_sequence_supported(dict(cfg, num_layers=12), 64, 376,
                                                     cuda_device)


@pytest.mark.cuda
def test_public_surface_launches_the_kernels(cuda_device):
    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal((3, 24 * 256)) * 3000).astype(np.int16)
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=3, device="gpu")
    counts = (floor.launches, gru.launches, engine_fused.launches)
    out = kb.process_chunk(pcm)
    assert (floor.launches - counts[0], gru.launches - counts[1]) == (1, 1)
    kb.reset()
    enh = kb.enhance(pcm)
    assert engine_fused.launches - counts[2] == 1
    assert out.shape == enh.shape == pcm.shape
    cpu = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=3, device="cpu")
    assert snr_db(cpu.process_chunk(pcm).astype(np.float64), out.astype(np.float64)) > 35.0
