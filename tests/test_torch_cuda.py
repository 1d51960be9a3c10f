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
from koala_tpu_torch.models import params_io
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
