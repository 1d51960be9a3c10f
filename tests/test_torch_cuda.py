"""Kernels of koala_tpu_torch on a CUDA card, each against its plain version,
and the public surface's launches. Marked ``cuda``: they skip where there is
no card. This file imports neither jax nor koala_tpu, so it also runs on a
machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import os

import numpy as np
import pytest
import torch

import koala_tpu_torch
from koala_tpu_torch.engine.core import make_engine
from koala_tpu_torch.models import mask_gru, params_io
from koala_tpu_torch.ops.kernels import engine_fused, floor, gru, rowmm

from torch_ref import ACCESS_KEY, cuda_device, snr_db  # noqa: F401  (fixture)

# bf16 tolerance of the GRU kernel against its plain version: the tensor
# cores sum in another order, and one flipped bf16 rounding of the streamed
# x feeds the recurrence (tests/test_pallas_gru.py's atol).
GRU_ATOL = 4e-2
# The fused engine's final h and floor against the plain version's: beside the
# GRU's own flips, a flipped bf16 rounding of a feature or of the encoder's
# output feeds the recurrence (0.048 seen at B = 300 over 40 hops); a flipped
# rounding of one band power moves its log, and so the floor, by up to 2**-8.
FUSED_H_ATOL = 0.1
FUSED_FLOOR_ATOL = 2e-2


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
@pytest.mark.parametrize("t_len,b,nb", [
    (376, 64, 32), (63, 64, 32),       # the serving and the training path's shapes
    (40, 37, 30),                      # B x nb = 1110: rows not 16-byte aligned
    (1, 5, 32), (0, 5, 32),            # one frame, none
    (130, 3, 7),                       # 21 columns over three slabs of 64 rows
    (200, 9, 36)])                     # 324 columns: the last block holds 4
def test_floor_kernel_shapes(cuda_device, t_len, b, nb):
    """Bit-identical to the plain version at every shape, one launch a call."""
    lb = _randn(t_len + b, (t_len, b, nb), 3.0, cuda_device)
    f0 = _randn(nb, (b, nb), 2.0, cuda_device) + 1.0
    before = floor.launches
    kf, kfl = floor.floor_scan(f0, lb, 0.012)
    rf, rfl = floor.floor_scan_ref(f0, lb, 0.012)
    torch.cuda.synchronize()
    assert floor.launches == before + 1
    assert kfl.shape == rfl.shape and torch.equal(kfl, rfl) and torch.equal(kf, rf)


@pytest.mark.cuda
def test_floor_kernel_unaligned_view(cuda_device):
    """lb that starts 4 bytes past an aligned address takes the 4-byte copies."""
    base = _randn(9, (50 * 8 * 32 + 1,), 3.0, cuda_device)
    lb = base[1:].view(50, 8, 32)
    f0 = torch.full((8, 32), 30.0, device=cuda_device)
    kf, kfl = floor.floor_scan(f0, lb, 0.012)
    rf, rfl = floor.floor_scan_ref(f0, lb, 0.012)
    torch.cuda.synchronize()
    assert torch.equal(kfl, rfl) and torch.equal(kf, rf)


@pytest.mark.cuda
def test_empty_launch_counts_nothing(cuda_device):
    before = floor.launches
    floor.empty_launch(cuda_device)
    torch.cuda.synchronize()
    assert floor.launches == before


@pytest.mark.cuda
def test_gru_kernel_matches_plain(cuda_device, bundled):
    """B = 40 spans three 16-row chunks, the last one ragged."""
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


def _random_gru(seed, t_len, b, hidden, layers, device, gain=1.5):
    scale = gain / hidden ** 0.5
    return (_randn(seed, (layers, b, hidden), 0.2, device),
            _randn(seed + 1, (t_len, b, hidden), 0.3, device).bfloat16(),
            _randn(seed + 2, (layers, hidden, 3 * hidden), scale, device).bfloat16(),
            _randn(seed + 3, (layers, 3 * hidden), 0.1, device),
            _randn(seed + 4, (layers, hidden, 3 * hidden), scale, device).bfloat16(),
            _randn(seed + 5, (layers, 3 * hidden), 0.1, device))


@pytest.mark.cuda
@pytest.mark.parametrize("t_len,b,hidden,layers", [
    (12, 1, 384, 2), (9, 17, 384, 2), (8, 64, 384, 2), (8, 128, 384, 2), (6, 300, 384, 2),
    (0, 5, 384, 2), (16, 40, 64, 1), (16, 64, 128, 3), (5, 300, 128, 3), (7, 33, 384, 3),
    (9, 64, 512, 3), (7, 33, 384, 5), (6, 64, 128, 12), (5, 20, 1024, 2)])
def test_gru_kernel_shapes(cuda_device, t_len, b, hidden, layers):
    """Single-row, ragged, many-pass and wide batches, one to three layers,
    T = 0, and wide stacks (layer groups, spilled units): both
    variants within the GRU tolerance of the plain version and bit-identical
    to each other, one launch a call, and the plan's shared-memory size the
    kernel's own."""
    from koala_tpu_torch.ops.kernels import _build

    args = _random_gru(10, t_len, b, hidden, layers, cuda_device)
    plan = gru.plan_for(args[1], layers)
    assert _build.library().koala_gru_smem_bytes(
        hidden, plan.block_layers, plan.slice_width, plan.chunk_rows) == plan.smem_bytes
    before = (gru.launches, gru.launches_hs)
    y0, hf0 = gru.gru_stack(*args)
    y, hs, hf = gru.gru_stack(*args, return_hidden=True)
    yr, hsr, hr = gru.gru_stack_ref(*args, return_hidden=True)
    torch.cuda.synchronize()
    assert (gru.launches, gru.launches_hs) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, y0) and torch.equal(hf, hf0)
    assert hs.shape == (t_len, layers, b, hidden)
    if t_len == 0:
        assert torch.equal(hf, args[0])
        return
    assert torch.equal(hs[-1], hf)
    assert (y.float() - yr.float()).abs().max().item() <= GRU_ATOL
    assert (hf - hr).abs().max().item() <= GRU_ATOL
    assert (hs - hsr).abs().max().item() <= GRU_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("t_len,b,hidden,layers", [(6, 8, 256, 17), (4, 8, 128, 67)])
def test_gru_kernel_deep_stacks(cuda_device, t_len, b, hidden, layers):
    """The deepest stacks that koala_tpu's kernel takes (three and six layer
    groups, units spilled into shared memory): both variants bit-identical
    to each other; h and hs within GRU_ATOL of the plain version, y within
    GRU_ATOL plus one bf16 spacing of its size (2**-7 |y|): the residual
    stream grows with the depth (|y| up to 14 here), and bf16 rounds it
    relative to its size. The weights have gain 0.5: at the other tests'
    1.5 a random stack this deep amplifies a flipped rounding layer by layer,
    far past GRU_ATOL (hs 0.70 apart in a run on an H100)."""
    args = _random_gru(10, t_len, b, hidden, layers, cuda_device, gain=0.5)
    plan = gru.plan_for(args[1], layers)
    assert plan.layer_groups > 1 and plan.spilled_units > 0
    y0, hf0 = gru.gru_stack(*args)
    y, hs, hf = gru.gru_stack(*args, return_hidden=True)
    yr, hsr, hr = gru.gru_stack_ref(*args, return_hidden=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y0) and torch.equal(hf, hf0) and torch.equal(hs[-1], hf)
    errs = {"y": (y.float() - yr.float()).abs(), "h_final": (hf - hr).abs(),
            "hs": (hs - hsr).abs()}
    report = {k: float(v.max()) for k, v in errs.items()}
    assert (errs["y"] <= GRU_ATOL + 2.0 ** -7 * yr.float().abs()).all(), report
    assert report["h_final"] <= GRU_ATOL and report["hs"] <= GRU_ATOL, report


@pytest.mark.cuda
def test_gru_kernel_chunked_and_repeatable(cuda_device, bundled):
    """A sequence in two chunks (state handed over through h_final / h0)
    equals one run bit for bit, and so do two launches on the same inputs."""
    params = params_io.params_from_numpy(bundled[0], cuda_device)
    w = params.gru_stacked()
    x = _randn(1, (29, 40, 384), 0.3, cuda_device).bfloat16()
    h0 = _randn(2, (2, 40, 384), 0.2, cuda_device)
    y, hs, hf = gru.gru_stack(h0, x, *w, return_hidden=True)
    ya, hsa, ha = gru.gru_stack(h0, x[:11], *w, return_hidden=True)
    yb, hsb, hb = gru.gru_stack(ha, x[11:], *w, return_hidden=True)
    y2, hs2, hf2 = gru.gru_stack(h0, x, *w, return_hidden=True)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([ya, yb]), y) and torch.equal(hb, hf)
    assert torch.equal(torch.cat([hsa, hsb]), hs)
    assert torch.equal(y2, y) and torch.equal(hs2, hs) and torch.equal(hf2, hf)


@pytest.mark.cuda
def test_gru_kernel_same_bits_over_many_launches(cuda_device):
    """The serving path's shape (T = 376, B = 64, 96 blocks) thirty times: a
    stale read past a grid barrier would show as a launch that differs."""
    args = _random_gru(40, 376, 64, 384, 2, cuda_device)
    first = gru.gru_stack(*args, return_hidden=True)
    for _ in range(30):
        again = gru.gru_stack(*args, return_hidden=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_grid_barriers_launch(cuda_device):
    """The barriers-only launch on a GRU plan's grid runs to its end and is
    no launch of the GRU kernel."""
    plan = gru.plan_launch(64, 384, 2, sms=torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    before = (gru.launches, gru.launches_hs)
    gru.grid_barriers(plan, plan.barriers(50), cuda_device)
    torch.cuda.synchronize()
    assert (gru.launches, gru.launches_hs) == before


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


def _fused_state_equal(a, b):
    return (torch.equal(a["input_carry"], b["input_carry"]) and torch.equal(a["ola"], b["ola"])
            and torch.equal(a["model"]["h"], b["model"]["h"])
            and torch.equal(a["model"]["floor"], b["model"]["floor"]))


@pytest.mark.cuda
def test_fused_kernel_matches_plain(cuda_device, bundled):
    """B = 40: >= 40 dB against the plain version; chunked equals continuous
    bit for bit; a call is five device launches (one segment)."""
    tree, cfg = bundled
    params = params_io.params_from_numpy(tree, cuda_device)
    hops = _randn(3, (40, 24, 256), 0.05, cuda_device)
    state = make_engine("mask_gru", cfg).init_state((40,), cuda_device)
    before = (engine_fused.launches, engine_fused.device_launches, gru.launches,
              floor.launches)
    st, out = engine_fused.fused_sequence(params, state, hops, cfg)
    _, ref = engine_fused.fused_sequence_ref(params, state, hops, cfg)
    st_a, a = engine_fused.fused_sequence(params, state, hops[:, :8], cfg)
    st_b, b = engine_fused.fused_sequence(params, st_a, hops[:, 8:], cfg)
    torch.cuda.synchronize()
    assert engine_fused.launches == before[0] + 3
    assert engine_fused.device_launches == before[1] + 15
    # the stages are the fused entry's own: the stand-alone wrappers count nothing
    assert (gru.launches, floor.launches) == before[2:]
    assert snr_db(ref.cpu().numpy(), out.cpu().numpy()) >= 40.0
    assert torch.equal(torch.cat([a, b], dim=1), out)
    assert _fused_state_equal(st_b, st)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_len", [(1, 40), (17, 40), (128, 40), (300, 40), (64, 8),
                                     (5, 1), (300, 104), (512, 64)])
def test_fused_kernel_shapes(cuda_device, bundled, b, t_len):
    """Single-stream, ragged and wide batches, T = 8 and T = 1, B = 300 x
    T = 104, which crosses a workspace segment (99 hops), and the bench's
    B = 512 over two segments (58 hops each): from a state that
    is not zero, >= 40 dB from the plain version on output and state close;
    two launches give the same bits."""
    tree, cfg = bundled
    params = params_io.params_from_numpy(tree, cuda_device)
    hops = _randn(b + t_len, (b, t_len + 8, 256), 0.05, cuda_device)
    zero = make_engine("mask_gru", cfg).init_state((b,), cuda_device)
    state, _ = engine_fused.fused_sequence(params, zero, hops[:, :8], cfg)
    hops = hops[:, 8:]
    lay = engine_fused.Layout(cfg)
    seg = engine_fused.segment_hops(b, engine_fused.frame_bytes(lay.hidden, lay.nbp))
    before = engine_fused.device_launches
    st, out = engine_fused.fused_sequence(params, state, hops, cfg)
    assert engine_fused.device_launches - before == 5 * -(-t_len // seg)
    st2, out2 = engine_fused.fused_sequence(params, state, hops, cfg)
    rst, ref = engine_fused.fused_sequence_ref(params, state, hops, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert snr_db(ref.cpu().numpy(), out.cpu().numpy()) >= 40.0
    assert snr_db(rst["ola"].cpu().numpy(), st["ola"].cpu().numpy()) >= 40.0
    assert (st["model"]["h"] - rst["model"]["h"]).abs().max().item() <= FUSED_H_ATOL
    assert (st["model"]["floor"] - rst["model"]["floor"]).abs().max().item() <= FUSED_FLOOR_ATOL
    assert torch.equal(st["input_carry"], rst["input_carry"])
    assert torch.equal(out, out2) and _fused_state_equal(st, st2)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [
    dict(hidden=64, num_layers=1, snr_bands=24),      # bands padded to 32, two idle warp columns
    dict(hidden=128, num_layers=3, cep_feats=0),      # no cepstral stage
    dict(hidden=208, num_layers=1, snr_bands=40),     # ragged passes: 208 and 48 columns
    dict(hidden=512, num_layers=3)])                  # the GRU stage in two layer groups
def test_fused_kernel_other_configs(cuda_device, overrides):
    """Widths and depths away from the bundled model's, on seeded random
    weights with the gate opened: >= 40 dB from the plain version, chunked
    equal to continuous bit for bit."""
    cfg = dict(mask_gru.TRAIN_CONFIG, **overrides)
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    params = mask_gru.init_params(gen, cfg)
    with torch.no_grad():
        params.gate.w.copy_(_randn(22, tuple(params.gate.w.shape), 0.1, cuda_device))
    assert engine_fused.fused_sequence_supported(cfg, 19, 24, cuda_device)
    hops = _randn(23, (19, 24, 256), 0.05, cuda_device)
    state = make_engine("mask_gru", cfg).init_state((19,), cuda_device)
    st, out = engine_fused.fused_sequence(params, state, hops, cfg)
    rst, ref = engine_fused.fused_sequence_ref(params, state, hops, cfg)
    st_a, a = engine_fused.fused_sequence(params, state, hops[:, :8], cfg)
    st_b, b = engine_fused.fused_sequence(params, st_a, hops[:, 8:], cfg)
    torch.cuda.synchronize()
    assert snr_db(ref.cpu().numpy(), out.cpu().numpy()) >= 40.0
    assert st["model"]["floor"].shape == rst["model"]["floor"].shape == (19, cfg["snr_bands"])
    assert (st["model"]["floor"] - rst["model"]["floor"]).abs().max().item() <= FUSED_FLOOR_ATOL
    assert (st["model"]["h"] - rst["model"]["h"]).abs().max().item() <= FUSED_H_ATOL
    assert torch.equal(torch.cat([a, b], dim=1), out) and _fused_state_equal(st_b, st)


@pytest.mark.cuda
def test_fused_segments_equal_calls(cuda_device, bundled):
    """B = 300 x T = 104 in one call (two workspace segments, 99 + 5 hops)
    against two calls of one segment each, cut elsewhere: the same bits."""
    tree, cfg = bundled
    params = params_io.params_from_numpy(tree, cuda_device)
    hops = _randn(12, (300, 104, 256), 0.05, cuda_device)
    state = make_engine("mask_gru", cfg).init_state((300,), cuda_device)
    st, out = engine_fused.fused_sequence(params, state, hops, cfg)
    st_a, a = engine_fused.fused_sequence(params, state, hops[:, :40], cfg)
    st_b, b = engine_fused.fused_sequence(params, st_a, hops[:, 40:], cfg)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([a, b], dim=1), out) and _fused_state_equal(st_b, st)


@pytest.mark.cuda
def test_fused_stage_times(cuda_device, bundled):
    """``stage_ms`` receives a time for each of the five stages and changes
    nothing of the result."""
    tree, cfg = bundled
    params = params_io.params_from_numpy(tree, cuda_device)
    hops = _randn(3, (40, 24, 256), 0.05, cuda_device)
    state = make_engine("mask_gru", cfg).init_state((40,), cuda_device)
    times = {}
    st, out = engine_fused.fused_sequence(params, state, hops, cfg, stage_ms=times)
    st2, out2 = engine_fused.fused_sequence(params, state, hops, cfg)
    torch.cuda.synchronize()
    assert tuple(times) == engine_fused.STAGES and all(v > 0.0 for v in times.values())
    assert torch.equal(out, out2) and _fused_state_equal(st, st2)


@pytest.mark.cuda
def test_fused_gate_shared_memory(cuda_device, bundled):
    """The bundled model has a GRU launch plan and its widest stage fits the
    card's shared memory; 768 x 3 layers have no plan, and at hidden = 1024 the
    back stage's block does not fit. A refused shape raises, it does not fall
    back."""
    from koala_tpu_torch.ops.kernels import _build

    cfg = bundled[1]
    lay = engine_fused.Layout(cfg)
    assert _build.library().koala_engine_fused_smem(lay.nbp, lay.hidden) <= \
        engine_fused.SMEM_LIMIT
    assert engine_fused.fused_sequence_supported(cfg, 64, 376, cuda_device)
    assert engine_fused.fused_sequence_supported(cfg, 1, 1, cuda_device)
    assert not engine_fused.fused_sequence_supported(dict(cfg, hidden=768, num_layers=3), 64,
                                                     376, cuda_device)
    assert _build.library().koala_engine_fused_smem(lay.nbp, 1024) > engine_fused.SMEM_LIMIT
    assert not engine_fused.fused_sequence_supported(dict(cfg, hidden=1024), 64, 376,
                                                     cuda_device)
    params = params_io.params_from_numpy(bundled[0], cuda_device)
    state = make_engine("mask_gru", cfg).init_state((4,), cuda_device)
    with pytest.raises(ValueError):
        engine_fused.fused_sequence(params, state, torch.zeros((4, 8, 256), device=cuda_device),
                                    dict(cfg, hidden=768, num_layers=3))


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


@pytest.mark.cuda
def test_single_stream_enhance_launches_the_kernels(cuda_device, monkeypatch):
    """One stream's ``Koala.enhance`` on the card launches the floor and GRU
    kernels once each a call and no plain version, and lands within 35 dB of
    the port on the CPU."""
    def refuse(name):
        def plain(*args, **kwargs):
            raise AssertionError("%s ran on the card" % name)
        return plain

    for module, name in ((mask_gru, "floor_scan_ref"), (mask_gru, "_gru_recurrent"),
                         (floor, "floor_scan_ref"), (gru, "gru_stack_ref")):
        monkeypatch.setattr(module, name, refuse(name))
    rng = np.random.default_rng(5)
    pcm = (rng.standard_normal(3 * 16000) * 3000).astype(np.int16)
    k = koala_tpu_torch.create(ACCESS_KEY, device="gpu")
    for _ in range(2):
        k.reset()
        counts = (floor.launches, gru.launches, engine_fused.launches)
        out = k.enhance(pcm)
        assert (floor.launches - counts[0], gru.launches - counts[1],
                engine_fused.launches - counts[2]) == (1, 1, 0)
    monkeypatch.undo()
    cpu = koala_tpu_torch.create(ACCESS_KEY, device="cpu")
    want = cpu.enhance(pcm)
    assert out.shape == want.shape == pcm.shape
    assert snr_db(want.astype(np.float64), out.astype(np.float64)) > 35.0



@pytest.mark.cuda
def test_mmse_process_chunk_on_the_card(cuda_device, tmp_path):
    """The mmse model through ``process_chunk`` on the card: >= 35 dB from
    the port on the CPU; of the port's kernels beside ``rowmm`` only its gain
    kernel, once."""
    from koala_tpu_torch.models import mmse
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel

    path = str(tmp_path / "mmse.pv")
    params_io.save_params(path, mmse.init_params(), mmse.DEFAULT_CONFIG)
    rng = np.random.default_rng(6)
    pcm = (rng.standard_normal((3, 40 * 256)) * 3000).astype(np.int16)
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=3, model_path=path, device="gpu")
    counts = (floor.launches, gru.launches, gru.launches_hs, engine_fused.launches)
    gains = mmse_kernel.launches
    out = kb.process_chunk(pcm)
    assert (floor.launches, gru.launches, gru.launches_hs, engine_fused.launches) == counts
    assert mmse_kernel.launches == gains + 1
    cpu = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=3, model_path=path, device="cpu")
    want = cpu.process_chunk(pcm)
    assert out.shape == want.shape == pcm.shape
    for i in range(3):
        assert snr_db(want[i].astype(np.float64), out[i].astype(np.float64)) > 35.0


# ---- the mmse gain kernel (csrc/mmse.cu) against its plain version

MMSE_RULE = (0.96, 0.92, 0.03, 1e6)     # models/mmse.py gain_rule(None)


def _mmse_case(n, t_len, device, seed=0, lo=1e-6, hi=1e3):
    """re, im [n, t_len, 257] on ``device``, each (stream, frame) at its own
    level between ``lo`` and ``hi``, so the SNR clamps at both ends are
    reached."""
    g = torch.Generator(device=device).manual_seed(seed)
    level = torch.exp(torch.empty(n, t_len, 1, device=device).uniform_(
        float(np.log(lo)), float(np.log(hi)), generator=g))
    return tuple(torch.randn(n, t_len, 257, device=device, generator=g) * level
                 for _ in range(2))


def _mmse_state(n, device):
    from koala_tpu_torch.models import mmse

    st = mmse.init_state((n,), mmse.DEFAULT_CONFIG, device)
    return st["noise"], st["prev_gain2_post"], st["count"]


def _assert_same(got, want):
    names = ("noise", "prev_gain2_post", "count", "mask")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 64, 8192])
@pytest.mark.parametrize("t_len", [1, 2, 375])
def test_mmse_gain_kernel_bit_identical(cuda_device, n, t_len):
    """Masks and every state leaf bit for bit the plain chain's on the card,
    one launch a call."""
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel

    re, im = _mmse_case(n, t_len, cuda_device, seed=n + t_len)
    args = (re, im) + _mmse_state(n, cuda_device) + MMSE_RULE
    before = mmse_kernel.launches
    got = mmse_kernel.mmse_gain(*args)
    torch.cuda.synchronize()
    assert mmse_kernel.launches == before + 1
    _assert_same(got, mmse_kernel.mmse_gain_ref(*args))


@pytest.mark.cuda
def test_mmse_gain_kernel_from_a_state_mid_stream(cuda_device):
    """A starting state taken mid-stream (count 40, noise adapted, the
    decision-directed term warm), and state carried over two calls against
    one call over the joined frames."""
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel

    re, im = _mmse_case(64, 140, cuda_device, seed=5)
    st = mmse_kernel.mmse_gain_ref(re[:, :40], im[:, :40], *_mmse_state(64, cuda_device),
                                   *MMSE_RULE)[:3]
    assert float(st[2][0]) == 40.0 and float(st[1].max()) > 0.0
    one = mmse_kernel.mmse_gain(re[:, 40:].contiguous(), im[:, 40:].contiguous(), *st,
                                *MMSE_RULE)
    _assert_same(one, mmse_kernel.mmse_gain_ref(re[:, 40:], im[:, 40:], *st, *MMSE_RULE))
    first = mmse_kernel.mmse_gain(re[:, 40:97].contiguous(), im[:, 40:97].contiguous(), *st,
                                  *MMSE_RULE)
    second = mmse_kernel.mmse_gain(re[:, 97:].contiguous(), im[:, 97:].contiguous(),
                                   *first[:3], *MMSE_RULE)
    _assert_same(second[:3] + (torch.cat([first[3], second[3]], dim=1),), one)


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(1e-12, 1e-8), (1e4, 1e8), (1e-12, 1e8)],
                         ids=["quiet", "loud", "both"])
def test_mmse_gain_kernel_at_the_clamps(cuda_device, lo, hi):
    """Inputs so quiet that the noise floor of 1e-10 holds, and so loud (or
    jumping from one to the other) that the SNR cap of 1e6 does: still bit
    for bit."""
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel

    re, im = _mmse_case(64, 200, cuda_device, seed=9, lo=lo, hi=hi)
    args = (re, im) + _mmse_state(64, cuda_device) + MMSE_RULE
    got = mmse_kernel.mmse_gain(*args)
    want = mmse_kernel.mmse_gain_ref(*args)
    _assert_same(got, want)
    if hi < 1e-6:          # the noise PSD sits on its floor
        assert float(got[0].min()) == float(np.float32(1e-10))
    if hi > 1e7:           # the first frame's SNR over the initial noise 1e-8 passes the cap
        assert bool(((re[:, 0] * re[:, 0] + im[:, 0] * im[:, 0]) / 1e-8 > 1e6).any())


@pytest.mark.cuda
def test_mmse_gain_kernel_off_the_ordinary_range(cuda_device):
    """Frames with extreme operands (powers near 1e-36, digital silence, a
    count of 2^60, an infinity, a NaN), beside ordinary ones in the same
    warps: the kernel gives the plain chain's values (NaN where it has NaN)."""
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel

    re, im = _mmse_case(64, 120, cuda_device, seed=13)
    re[0::5, 10:30] *= 1e-18                         # powers near 1e-36
    re[1::5, 40:60], im[1::5, 40:60] = 0.0, 0.0      # silence
    re[2::7, 70, 3::11] = float("inf")
    im[3::7, 90, 5::13] = float("nan")
    noise, prev, count = _mmse_state(64, cuda_device)
    count[4::8] = 2.0 ** 60
    args = (re, im, noise, prev, count) + MMSE_RULE
    got = mmse_kernel.mmse_gain(*args)
    want = mmse_kernel.mmse_gain_ref(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(got[3]).any()) and bool(torch.isfinite(got[3][0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(), (5,)], ids=["T_K", "B_T_K"])
def test_mmse_apply_sequence_launches_the_kernel_once(cuda_device, lead):
    """``apply_sequence`` on [T, K] (``Koala.enhance``) and [B, T, K] (the
    batch paths): one launch a call, the masks and state the plain chain's on
    the flattened streams."""
    from koala_tpu_torch.models import mmse
    from koala_tpu_torch.ops.kernels import mmse as mmse_kernel

    n = int(np.prod(lead, dtype=np.int64))
    re, im = _mmse_case(n, 90, cuda_device, seed=3)
    re, im = re.reshape(lead + (90, 257)), im.reshape(lead + (90, 257))
    state = mmse.init_state(lead, mmse.DEFAULT_CONFIG, cuda_device)
    before = mmse_kernel.launches
    st, mask = mmse.apply_sequence(None, state, re, im, mmse.DEFAULT_CONFIG)
    st, mask2 = mmse.apply_sequence(None, st, re, im, mmse.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    assert mmse_kernel.launches == before + 2
    want = mmse_kernel.mmse_gain_ref(re.reshape(n, 90, 257), im.reshape(n, 90, 257),
                                     *_mmse_state(n, cuda_device), *MMSE_RULE)
    assert mask.shape == re.shape and torch.equal(mask.reshape(n, 90, 257), want[3])
    want = mmse_kernel.mmse_gain_ref(re.reshape(n, 90, 257), im.reshape(n, 90, 257),
                                     *want[:3], *MMSE_RULE)
    assert torch.equal(mask2.reshape(n, 90, 257), want[3])
    for key, w in zip(("noise", "prev_gain2_post", "count"), want[:3]):
        assert st[key].shape == state[key].shape and torch.equal(st[key].reshape(w.shape), w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["process_chunk", "enhance"])
def test_card_snapshot_resumes_bit_for_bit(cuda_device, mode):
    """A stream cut at frame 16 on the card: its snapshot (host numpy)
    resumes a fresh card instance with the bits of the uninterrupted one."""
    rng = np.random.default_rng(7)
    pcm = (rng.standard_normal((3, 40 * 256)) * 3000).astype(np.int16)
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=3, device="gpu")
    run = getattr(kb, mode)
    run(pcm[:, :16 * 256])
    snap = kb.save_state()
    want = run(pcm[:, 16 * 256:])
    fresh = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=3, device="gpu")
    fresh.load_state(snap)
    assert all(v.dtype == np.float32 for v in snap.values())
    np.testing.assert_array_equal(getattr(fresh, mode)(pcm[:, 16 * 256:]), want)

def _pull_frames(server, streams, frames, timeout=60.0):
    import time

    got = np.zeros((streams, frames, 256), np.int16)
    have = np.zeros(streams, np.int64)
    deadline = time.time() + timeout
    while have.sum() < streams * frames and time.time() < deadline:
        rows, cnt = server.pull_block(frames)
        for i in np.nonzero(cnt)[0]:
            c = min(int(cnt[i]), frames - int(have[i]))
            got[i, have[i]:have[i] + c] = rows[i, :c]
            have[i] += c
        time.sleep(0.001)
    assert have.sum() == streams * frames, have
    return got


@pytest.mark.cuda
def test_server_backlog_rounds_launch_the_kernels(cuda_device):
    """Full-chunk backlog rounds of the StreamingServer on the card run the
    sequence engine (floor + GRU kernels), with process_chunk's bits on the
    card."""
    from koala_tpu_torch.serve import StreamingServer

    streams, frames = 8, 32
    rows = (np.random.default_rng(5).standard_normal((streams, frames, 256)) * 3000
            ).astype(np.int16)
    server = StreamingServer(ACCESS_KEY, num_streams=streams, device="gpu", chunk_frames=8,
                             capacity_frames=frames)
    try:
        before = (floor.launches, gru.launches)
        assert server.push_block(rows, np.full(streams, frames, np.int32)) == streams * frames
        got = _pull_frames(server, streams, frames)
        assert floor.launches > before[0] and gru.launches > before[1]
    finally:
        server.close()
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=streams, device="gpu")
    ref = kb.process_chunk(rows.reshape(streams, -1))
    np.testing.assert_array_equal(got.reshape(streams, -1), ref)


@pytest.mark.cuda
def test_server_single_frame_rounds_equal_batch_process(cuda_device):
    """Single-frame rounds (step_masked on the card, int16 converted on the
    card) give KoalaBatch.process's bits at the same pool size."""
    import time

    from koala_tpu_torch.serve import StreamingServer

    streams, frames = 8, 12
    rows = (np.random.default_rng(6).standard_normal((streams, frames, 256)) * 3000
            ).astype(np.int16)
    server = StreamingServer(ACCESS_KEY, num_streams=streams, device="gpu")
    try:
        for j in range(frames):
            server.push_block(rows[:, j:j + 1], np.ones(streams, np.int32))
            time.sleep(0.01)
        got = _pull_frames(server, streams, frames)
    finally:
        server.close()
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=streams, device="gpu")
    ref = np.stack([kb.process(rows[:, j]) for j in range(frames)], axis=1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
def test_one_rank_nccl_step_equals_unsharded_step(cuda_device):
    """make_train_step(mesh=...) under a one-rank NCCL group: the loss and
    the weights after a step are the unsharded step's bit for bit; and a
    CorpusRunner wash on that group sums its audio seconds on the card."""
    import copy
    import importlib
    import socket

    import torch.distributed as dist

    from koala_tpu_torch.parallel import make_mesh

    # the package re-exports the function ``train`` under the submodule's name
    trainer = importlib.import_module("koala_tpu_torch.train.train")
    cfg = dict(mask_gru.TRAIN_CONFIG, hidden=128)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    init = mask_gru.init_params(gen, cfg)
    noisy = torch.randn((8, 12 * 256), generator=gen, device=cuda_device) * 0.1
    clean = noisy * 0.5
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d" % port, rank=0,
                            world_size=1)
    try:
        out = []
        for mesh in (None, make_mesh(["gpu:0"])):
            p = copy.deepcopy(init).to(cuda_device).requires_grad_(True)
            step = trainer.make_train_step(cfg, trainer.make_optimizer(p, 1e-3, 10), mesh=mesh)
            out.append((step(p, noisy, clean), p))
        from koala_tpu_torch.parallel import CorpusRunner

        runner = CorpusRunner(params_io.default_model_path(), global_batch=2,
                              utterance_samples=16 * 256, mesh=make_mesh(["gpu:0"]))
        pcm = np.random.default_rng(9).standard_normal((2, 16 * 256)).astype(np.float32) * 0.1
        report = runner.wash([pcm] * 3, warmup=1)
    finally:
        dist.destroy_process_group()
    assert report["batches"] == 2 and report["chips"] == 1
    assert report["audio_seconds"] == 2 * 2 * 16 * 256 / 16000.0
    (l0, p0), (l1, p1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(p0.parameters(), p1.parameters()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_trace_records_the_card_kernels(cuda_device, tmp_path):
    """profiling.trace on a card records CUDA activity: the floor and GRU
    kernels of a process_chunk call appear as kernel events."""
    import json

    from koala_tpu_torch import profiling

    pcm = (np.random.default_rng(8).standard_normal((2, 16 * 256)) * 3000).astype(np.int16)
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=2, device="gpu")
    kb.process_chunk(pcm)                       # warm-up outside the trace
    with profiling.trace(str(tmp_path)) as log_dir:
        kb.process_chunk(pcm)
        torch.cuda.synchronize()
    with open("%s/%s" % (log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("gru" in k for k in kernels) and any("floor" in k for k in kernels), kernels[:20]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,layers,gru_launches", [(512, 3, 1), (384, 2, 1), (768, 3, 0)])
def test_gru_gate_on_the_card(cuda_device, tmp_path, hidden, layers, gru_launches):
    """A model with a launch plan launches the GRU kernel from process_chunk:
    384 x 2 in one layer group, 512 x 3 in two. One without (768 x 3, which
    koala_tpu's kernel refuses too) runs the scan branch (the floor kernel
    launches, the GRU kernel does not). All >= 35 dB from the port on the
    CPU."""
    cfg = dict(mask_gru.TRAIN_CONFIG, hidden=hidden, num_layers=layers)
    path = str(tmp_path / "m.pv")
    params_io.save_params(path, mask_gru.init_params(torch.Generator().manual_seed(5), cfg), cfg)
    pcm = (np.random.default_rng(10).standard_normal((6, 24 * 256)) * 3000).astype(np.int16)
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=6, model_path=path, device="gpu")
    before = (floor.launches, gru.launches)
    out = kb.process_chunk(pcm)
    assert (floor.launches - before[0], gru.launches - before[1]) == (1, gru_launches)
    cpu = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=6, model_path=path, device="cpu")
    assert snr_db(cpu.process_chunk(pcm).astype(np.float64), out.astype(np.float64)) > 35.0


@pytest.mark.cuda
def test_graphed_step_chain_equals_the_eager_chain(cuda_device):
    """bench_torch's chain of steps replayed from a CUDA graph leaves the
    bits that the same steps made eagerly on the card leave. The graph holds
    the GRU kernel (one cooperative launch at T = 1, captured), and an eager
    step launches it once."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench_torch

    engine, params = bench_torch.load_engine(cuda_device)
    hop = _randn(12, (256,), 0.05, cuda_device)
    with torch.inference_mode():
        before = gru.launches
        chain = bench_torch.StepChain(engine, params, engine.init_state((), cuda_device),
                                      hop.clone())
        assert chain.graph is not None
        assert gru.launches > before            # the warm-up's and the capture's
        before = gru.launches
        chain.run(40)
        assert gru.launches == before           # replays pass no wrapper
        state, out = engine.init_state((), cuda_device), hop
        for _ in range(40):
            state, out = engine.step(params, state, out)
        assert gru.launches == before + 40
    torch.cuda.synchronize()
    assert torch.equal(chain.hop, out)
    for k in ("input_carry", "ola"):
        assert torch.equal(chain.state[k], state[k])
    for k in ("h", "floor"):
        assert torch.equal(chain.state["model"][k], state["model"][k])


# (K, N) of the port's frame-local products: the STFT's two bases, the
# iSTFT's two, the band pool, the cepstral basis, the encoder, decoder and
# gate of the bundled model, and the scan branch's wx and wh
ROWMM_SITES = [(512, 257), (257, 512), (257, 32), (257, 161), (329, 384), (384, 257),
               (384, 1), (384, 1152)]
# rows of the call sites: one stream's frame, the battery's 21 streams, the
# main path's 64, a round of 8 frames of the battery, the battery's 365
# frames in one call, the main path's 376 x 64
ROWMM_ROWS = (1, 21, 64, 8 * 21, 365 * 21, 376 * 64)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", ROWMM_SITES)
def test_rowmm_matches_plain_at_the_call_sites(cuda_device, k, n):
    """The fixed-order product within 1e-5 of the largest element of its
    plain version (both float32: sums of up to 1152 products in another
    order), at every row count of the main paths."""
    b = _randn(41, (k, n), 0.1, cuda_device)
    for m in ROWMM_ROWS:
        a = _randn(40 + m, (m, k), 1.0, cuda_device)
        before = rowmm.launches
        got = rowmm.rowmm(a, b)
        assert rowmm.launches == before + 1
        want = rowmm.rowmm_ref(a, b)
        torch.cuda.synchronize()
        assert got.shape == (m, n)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), (m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(512, 257), (384, 1)])
def test_rowmm_row_bits_do_not_depend_on_the_rows(cuda_device, k, n):
    """A row of the product has the same bits at M = 1, 7, 64 and 24064, at
    the one-row kernel's limit and one row either side of it (another
    kernel above it), and wherever it lies in a tile."""
    a = _randn(42, (376 * 64, k), 1.0, cuda_device)
    b = _randn(43, (k, n), 0.1, cuda_device)
    full = rowmm.rowmm(a, b)
    for m in (1, 7, 64, rowmm.ROW_MAX - 1, rowmm.ROW_MAX, rowmm.ROW_MAX + 1, 376 * 64):
        for start in (0, 5, 63, 64 + 17, 376 * 64 - m):
            if start + m <= a.shape[0]:
                got = rowmm.rowmm(a[start:start + m].contiguous(), b)
                assert torch.equal(got, full[start:start + m]), (m, start)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", ROWMM_SITES)
def test_rowmm_equals_the_first_design_bit_for_bit(cuda_device, k, n):
    """The kernel that the plan picks gives the bits of rowmm_simple (the
    first design, one fmaf chain an element as every variant) at every row
    count of the main paths and at the one-row kernel's limit, one row
    either side of it."""
    b = _randn(47, (k, n), 0.1, cuda_device)
    for m in ROWMM_ROWS + (rowmm.ROW_MAX - 1, rowmm.ROW_MAX, rowmm.ROW_MAX + 1):
        a = _randn(48 + m, (m, k), 1.0, cuda_device)
        before = (rowmm.launches, rowmm.simple_launches)
        got, want = rowmm.rowmm(a, b), rowmm.rowmm_simple(a, b)
        assert (rowmm.launches, rowmm.simple_launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(got, want), (m, k, n, rowmm.plan(m, n, k).name)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 3, 1), (21, 33, 1), (600, 31, 1), (5, 7, 5),
                                   (64, 17, 257), (300, 331, 161), (700, 257, 33),
                                   (3000, 5, 200), (24064, 329, 1)])
def test_rowmm_every_variant_at_ragged_k_and_n(cuda_device, m, k, n):
    """Every variant, whatever the plan would pick, gives rowmm_simple's bits
    where K is no multiple of 4 nor of a K chunk, and at N = 1."""
    a = _randn(50, (m, k), 1.0, cuda_device)
    b = _randn(51, (k, n), 0.1, cuda_device)
    want = rowmm.rowmm_simple(a, b)
    for v in range(len(rowmm.VARIANTS)):
        if v == rowmm.COL and n != 1:
            continue
        got = rowmm.launch(a, b, rowmm.plan_for(v, m, n))
        assert torch.equal(got, want), (m, k, n, rowmm.VARIANTS[v][0])


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(384, 257), (384, 1), (512, 257), (257, 32)])
def test_rowmm_reads_unaligned_and_permuted_operands(cuda_device, k, n):
    """Operands that start one float past an aligned allocation, and A as a
    [B, T, K] view of a [T, B, K] tensor (the decoder's and the gate's input),
    give the bits of their contiguous, aligned copies, without a copy of A."""
    t_len, batch = 45, 7
    y = _randn(52, (t_len, batch, k), 1.0, cuda_device)
    b = _randn(53, (k, n), 0.1, cuda_device)
    view = y.transpose(0, 1)                                     # [B, T, K], permuted
    want = rowmm.rowmm_simple(view.contiguous(), b)
    assert torch.equal(rowmm.rowmm(view, b), want)
    base_a = torch.empty(view.numel() + 1, device=cuda_device)
    base_b = torch.empty(b.numel() + 1, device=cuda_device)
    off_a = base_a[1:].view(batch, t_len, k).copy_(view)
    off_b = base_b[1:].view(k, n).copy_(b)
    assert off_a.data_ptr() % 16 == 4 and off_b.data_ptr() % 16 == 4
    for m in (1, batch * t_len):
        for v in range(len(rowmm.VARIANTS)):
            if v == rowmm.COL and n != 1:
                continue
            got = rowmm.launch(off_a.reshape(-1, k)[:m], off_b, rowmm.plan_for(v, m, n))
            assert torch.equal(got, want.reshape(-1, n)[:m]), (m, rowmm.VARIANTS[v][0])
    with torch.inference_mode():
        assert torch.equal(rowmm.matmul(view, b), want)


@pytest.mark.cuda
def test_rowmm_variants_on_the_card_are_the_plans(cuda_device):
    """csrc/rowmm.cu's table of variants (rows, columns, threads of a block),
    read through koala_rowmm_variant, is the one the plan computes grids by."""
    assert rowmm.variants_on_card() == [v[1:] for v in rowmm.VARIANTS]


@pytest.mark.cuda
def test_rowmm_refuses_what_it_does_not_take(cuda_device):
    a = _randn(44, (8, 16), 1.0, cuda_device)
    b = _randn(45, (16, 4), 1.0, cuda_device)
    for bad_a, bad_b in ((a.bfloat16(), b), (a, b.double()), (a[:, :8], b),
                         (a.t(), b[:8]), (a, b.cpu())):
        with pytest.raises(ValueError):
            rowmm.rowmm(bad_a, bad_b)
    # B transposed, A with three row strides: refused, not copied
    three = _randn(46, (4, 5, 6, 16), 1.0, cuda_device).permute(1, 0, 2, 3)
    for bad_a, bad_b in ((a, _randn(45, (4, 16), 1.0, cuda_device).t()), (three, b)):
        with pytest.raises(ValueError):
            rowmm.rowmm(bad_a, bad_b)
    with pytest.raises(ValueError):
        rowmm.rowmm_simple(a.t(), b[:8])


@pytest.mark.cuda
def test_gru_kernel_gives_a_stream_the_same_bits_at_any_batch(cuda_device, bundled):
    """The GRU kernel sums a row without the other rows: a stream has the
    same bits at B = 1, 21 and 64, at another row of the batch, and over
    T = 40 steps in one launch or 40 chained launches at T = 1."""
    tree, _ = bundled
    params = params_io.params_from_numpy(tree, cuda_device)
    weights = params.gru_stacked()
    x = _randn(46, (40, 64, 384), 1.0, cuda_device).bfloat16()
    h0 = _randn(47, (2, 64, 384), 0.5, cuda_device)
    with torch.inference_mode():
        y64, h64 = gru.gru_stack(h0, x, *weights)
        for b in (1, 21):
            y, h = gru.gru_stack(h0[:, :b].contiguous(), x[:, :b].contiguous(), *weights)
            assert torch.equal(y, y64[:, :b]) and torch.equal(h, h64[:, :b]), b
        perm = torch.randperm(64, generator=torch.Generator().manual_seed(0)).to(cuda_device)
        y, h = gru.gru_stack(h0[:, perm].contiguous(), x[:, perm].contiguous(), *weights)
        assert torch.equal(y, y64[:, perm]) and torch.equal(h, h64[:, perm])
        h, ys = h0, []
        for t in range(40):
            y, h = gru.gru_stack(h, x[t:t + 1].contiguous(), *weights)
            ys.append(y)
        assert torch.equal(torch.cat(ys), y64) and torch.equal(h, h64)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mask_gru", "mmse"])
def test_round_shapes_agree_bit_for_bit(cuda_device, tmp_path, model):
    """One process_chunk call over 40 frames, rounds of 1, 8 and 32 frames,
    40 KoalaBatch.process calls, one stream's Koala.process frame by frame
    and its Koala.enhance: the same int16, bit for bit. An eager step
    launches the GRU kernel once (mask_gru) and calls no plain version."""
    path = params_io.default_model_path()
    if model == "mmse":
        from koala_tpu_torch.models import mmse

        path = str(tmp_path / "mmse.pv")
        params_io.save_params(path, mmse.init_params(), mmse.DEFAULT_CONFIG)
    streams, frames = 5, 40
    pcm = (np.random.default_rng(11).standard_normal((streams, frames * 256)) * 3000
           ).astype(np.int16)
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=streams, model_path=path,
                                      device="gpu")
    one = kb.process_chunk(pcm)
    for r in (1, 8, 32):
        kb.reset()
        got = np.concatenate([kb.process_chunk(pcm[:, j * 256:(j + r) * 256])
                              for j in range(0, frames, r)], axis=1)
        np.testing.assert_array_equal(got, one, err_msg="rounds of %d" % r)
    kb.reset()
    before = (gru.launches, rowmm.launches)
    got = np.concatenate([kb.process(pcm[:, j * 256:(j + 1) * 256]) for j in range(frames)],
                         axis=1)
    assert gru.launches - before[0] == (frames if model == "mask_gru" else 0)
    assert rowmm.launches > before[1]
    np.testing.assert_array_equal(got, one)
    k = koala_tpu_torch.create(ACCESS_KEY, model_path=path, device="gpu")
    got = np.concatenate([k.process(pcm[2, j * 256:(j + 1) * 256].tolist())
                          for j in range(frames)])
    np.testing.assert_array_equal(got, one[2])
    k.reset()
    enh = k.enhance(pcm[2])
    np.testing.assert_array_equal(enh[:-256], one[2, 256:])


@pytest.mark.cuda
def test_server_rounds_of_every_shape_equal_process_chunk(cuda_device):
    """The server's backlog in rounds of 32 and of 8 frames and its
    single-frame rounds (the step graph, which holds the GRU kernel) give
    process_chunk's bits; a replay moves ``graph_replays``."""
    import time

    from koala_tpu_torch import serve
    from koala_tpu_torch.serve import StreamingServer

    streams, frames = 6, 40
    rows = (np.random.default_rng(12).standard_normal((streams, frames, 256)) * 3000
            ).astype(np.int16)
    kb = koala_tpu_torch.create_batch(ACCESS_KEY, batch_size=streams, device="gpu")
    want = kb.process_chunk(rows.reshape(streams, -1)).reshape(streams, frames, 256)
    for chunk in (32, 8, 1):
        server = StreamingServer(ACCESS_KEY, num_streams=streams, device="gpu",
                                 chunk_frames=chunk, capacity_frames=frames)
        replays = serve.graph_replays
        try:
            if chunk > 1:
                server.push_block(rows, np.full(streams, frames, np.int32))
            else:
                for j in range(frames):
                    server.push_block(rows[:, j:j + 1], np.ones(streams, np.int32))
                    time.sleep(0.005)
            got = _pull_frames(server, streams, frames)
        finally:
            server.close()
        np.testing.assert_array_equal(got, want, err_msg="chunk %d" % chunk)
        if chunk != 8:                           # 40 frames leave 8 past the last 32
            assert serve.graph_replays > replays


# -- the program's spans on the card ------------------------------------------

def _profiled(fn):
    """Run ``fn`` under a CPU + CUDA profiler (the card synchronised at the
    end); -> the card's events (kernels, copies, annotations) and the spans."""
    import time

    from koala_tpu_torch import profiling

    torch.cuda.synchronize()                    # nothing queued before runs inside
    t0 = time.time_ns()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    card = [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    return card, profiling.spans(t0, time.time_ns())


@pytest.mark.cuda
def test_fused_span_counts_the_segments_walked(cuda_device, bundled):
    """``sequence_fast`` at B = 300 x 107 hops: the fused entry walks 104
    hops in ceil(104 / segment_hops) segments (two: 99 + 5), the 3-hop tail
    goes through ``engine.sequence``."""
    tree, cfg = bundled
    engine = make_engine("mask_gru", cfg)
    params = params_io.params_from_numpy(tree, cuda_device)
    hops = _randn(13, (300, 107, 256), 0.05, cuda_device)
    state = engine.init_state((300,), cuda_device)
    engine.sequence_fast(params, state, hops)                  # built and warm
    _, spans = _profiled(lambda: engine.sequence_fast(params, state, hops))
    lay = engine_fused.Layout(cfg)
    seg = engine_fused.segment_hops(300, engine_fused.frame_bytes(lay.hidden, lay.nbp))
    (fused,) = [s for s in spans if s.name == "engine.fused"]
    (tail,) = [s for s in spans if s.name == "engine.sequence"]
    assert fused.counts == {"hops": 104, "segments": -(-104 // seg)} and seg == 99
    assert tail.counts == {"hops": 3} and fused.end_ns <= tail.start_ns


def _runner_batch(pinned):
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    b, samples = 64, 375 * 256
    runner = CorpusRunner(params_io.default_model_path(), global_batch=b,
                          utterance_samples=samples, mesh=make_mesh(["gpu:0"]))
    host = torch.empty((b, samples), dtype=torch.float32, pin_memory=pinned)
    host.copy_(_randn(14, (b, samples), 0.05, "cpu"))
    return runner, host.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [True, False])
def test_runner_upload_counts_pageable_bytes(cuda_device, pinned):
    """A page-locked batch (as a loader with ``pin_memory=True`` hands it
    over) reports no pageable bytes and stages none through the ring (its
    DMA reads the caller's memory); numpy's own memory reports them all
    pageable, and all staged. ``ring_waits`` counts the host's waits for a
    slot."""
    runner, pcm = _runner_batch(pinned)
    runner.enhance_batch(pcm)
    _, spans = _profiled(lambda: runner.enhance_batch(pcm))
    (up,) = [s for s in spans if s.name == "runner.upload"]
    counts = dict(up.counts)
    waits = counts.pop("ring_waits")
    assert counts == {"bytes": pcm.nbytes, "pageable_bytes": 0 if pinned else pcm.nbytes,
                      "staged_bytes": 0 if pinned else pcm.nbytes}
    assert isinstance(waits, int) and waits >= 0 and (waits == 0 or not pinned)
    assert {s.name for s in spans} == {"runner.issue", "runner.upload", "runner.launch",
                                       "engine.fused", "engine.sequence", "engine.model"}


@pytest.mark.cuda
def test_spans_add_no_event_on_the_card(cuda_device, monkeypatch):
    """A profiled ``CorpusRunner`` batch (the fused entry and the tail) has
    the same card events, by name, with the spans recorded as with the
    recorder's check patched off."""
    from koala_tpu_torch import profiling

    runner, pcm = _runner_batch(False)
    runner.enhance_batch(pcm)
    on, spans = _profiled(lambda: runner.enhance_batch(pcm))
    monkeypatch.setattr(profiling, "recording", lambda: False)
    off, none = _profiled(lambda: runner.enhance_batch(pcm))
    assert len(spans) == 6 and none == []
    assert sorted(on) == sorted(off) and any("gru" in n for n in on)


def _ring_batch_rows(samples):
    """A batch size whose bytes pass the whole ring and are no multiple of
    a slot: the ring wraps, and its last chunk is ragged."""
    from koala_tpu_torch.parallel import upload

    b = upload.SLOTS * upload.SLOT_BYTES // (samples * 4) + 3
    assert b * samples * 4 > upload.SLOTS * upload.SLOT_BYTES
    assert (b * samples * 4) % upload.SLOT_BYTES
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [True, False])
def test_runner_batches_equal_sequence_fast_alone(cuda_device, pinned):
    """Batches A, B, A, C run back to back (a reused input buffer or
    ring slot would show) each equal ``Engine.sequence_fast`` run alone on
    that batch, bit for bit; each caller's array is overwritten as soon as
    ``enhance_batch`` returns, which must not change its output."""
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    samples = 375 * 256
    b = _ring_batch_rows(samples)
    runner = CorpusRunner(params_io.default_model_path(), global_batch=b,
                          utterance_samples=samples, mesh=make_mesh(["gpu:0"]))
    base = [_randn(20 + i, (b, samples), 0.05, "cpu").numpy() for i in range(3)]
    order = [0, 1, 0, 2]
    outs = []
    for k in order:
        host = torch.empty((b, samples), dtype=torch.float32, pin_memory=pinned)
        host.copy_(torch.from_numpy(base[k]))
        pcm = host.numpy()
        outs.append(runner.enhance_batch(pcm))
        pcm[:] = 7.0                            # the caller reuses its array at once
    engine, params = runner.engine, runner.params[0]
    with torch.inference_mode():
        for k, out in zip(order, outs):
            hops = torch.as_tensor(base[k].reshape(b, 375, 256), device=cuda_device)
            _, want = engine.sequence_fast(params, engine.init_state((b,), cuda_device), hops)
            assert torch.equal(out, want)


@pytest.mark.cuda
def test_runner_copies_run_beside_the_kernels(cuda_device, tmp_path):
    """In a profiled pair of pageable batches, every host-to-card copy of
    the batch runs on a stream other than the kernels': the second batch's
    upload is not queued behind the first batch's kernels."""
    import json

    from koala_tpu_torch.parallel import CorpusRunner, make_mesh, upload

    samples = 375 * 256
    b = _ring_batch_rows(samples)
    runner = CorpusRunner(params_io.default_model_path(), global_batch=b,
                          utterance_samples=samples, mesh=make_mesh(["gpu:0"]))
    pcm = [_randn(30 + i, (b, samples), 0.05, "cpu").numpy() for i in range(2)]
    runner.enhance_batch(pcm[0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for x in pcm:
            runner.enhance_batch(x)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["args"]["stream"] for e in events if e.get("cat") == "kernel"}
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
              and e["args"].get("bytes", 0) >= 1 << 16]
    # the profiler may lose the first copy of a stretch: at least the second
    # batch's chunks are there
    assert len(copies) >= -(-b * samples * 4 // upload.SLOT_BYTES)
    assert kernels and not kernels & {e["args"]["stream"] for e in copies}


# -- FullSubNet and the LSTM-cell kernel --------------------------------------

# the LSTM kernel against its plain version: the same bf16 operands, f32 sums
# in another order (the tensor cores' against the library's), so the gates
# differ in their last bits and h' and c' by about 1e-6
LSTM_ATOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FSN_MODEL = os.path.join(REPO, "models", "fullsubnet", "fullsubnet_random.pv")
# (kx, H) of FullSubNet's four layer-steps: the full band's, the sub-band's
LSTM_WIDTHS = [(257, 512), (512, 512), (32, 384), (384, 384)]


def _lstm_case(kx, h, rows, device, seed=0):
    from koala_tpu_torch.ops.kernels import lstm

    g = torch.Generator(device="cpu").manual_seed(seed + kx + h)
    w_ih = torch.rand(4 * h, kx, generator=g) * 2 - 1
    w_hh = torch.rand(4 * h, h, generator=g) * 2 - 1
    b_ih, b_hh = (torch.rand(4 * h, generator=g) * 2 - 1 for _ in range(2))
    w, b = lstm.stack_weights(w_ih / h ** 0.5, w_hh / h ** 0.5, b_ih / h ** 0.5, b_hh / h ** 0.5)
    # the state as the model holds it: [rows, 2, H], the cell on layer 1's rows
    x = torch.randn(rows, kx, device=device)
    state = torch.randn(rows, 2, h, device=device)
    return x, state[:, 1], state[:, 0] * 2, w.to(device), b.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kx,h", LSTM_WIDTHS)
@pytest.mark.parametrize("rows", [1, 64, 526336])
def test_lstm_kernel_matches_its_plain_version(cuda_device, kx, h, rows):
    from koala_tpu_torch.ops.kernels import lstm

    if rows == 526336 and h == 512:
        rows = 2048          # the full band runs on B rows, not B x 257
    x, h0, c0, w, b = _lstm_case(kx, h, rows, cuda_device)
    before = lstm.launches
    out_h, out_c = torch.empty(rows, 2, h, device=cuda_device), torch.empty(rows, 2, h,
                                                                          device=cuda_device)
    lstm.lstm_cell(x, h0, c0, w, b, out_h[:, 0], out_c[:, 0])
    torch.cuda.synchronize()
    assert lstm.launches == before + 1
    ref_h, ref_c = lstm.lstm_cell_ref(x, h0, c0, w, b)
    assert (out_h[:, 0] - ref_h).abs().max() < LSTM_ATOL
    assert (out_c[:, 0] - ref_c).abs().max() < LSTM_ATOL
    assert torch.isfinite(out_h[:, 0]).all() and float(out_h[:, 0].abs().max()) > 0.1


# rows of the whole launch a row count's bits are held to: the sub-band's 2048
# x 257, the full band's 4 x 2048 (so 4112 rows fit and its persistent walk
# wraps the grid too)
LSTM_FULL_ROWS = {384: 526336, 512: 8192}


@pytest.fixture(scope="module")
def lstm_full_launch():
    """(kx, H, device) -> the case at LSTM_FULL_ROWS[H] rows and its h', c'
    from one launch over all of them; the last width's kept."""
    from koala_tpu_torch.ops.kernels import lstm

    held = {}

    def get(kx, h, device):
        if (kx, h) not in held:
            held.clear()
            case = _lstm_case(kx, h, LSTM_FULL_ROWS[h], device)
            held[(kx, h)] = case, lstm.lstm_cell(*case)
        return held[(kx, h)]
    yield get
    held.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("kx,h", LSTM_WIDTHS)
@pytest.mark.parametrize("rows", [1, 64, 127, 128, 129, 257, 4112, "ragged"])
def test_lstm_kernel_gives_a_row_the_same_bits_at_any_row_count(cuda_device, lstm_full_launch,
                                                               kx, h, rows):
    """A row's bits in a launch over 1 row, 64, a 128-row tile and one row
    less or more, a stream's 257 (the passes split over blocks), 16 streams'
    4112 and all but 29 rows of the whole (a ragged last tile of the
    persistent walk) are those it has in the whole launch."""
    from koala_tpu_torch.ops.kernels import lstm

    (x, h0, c0, w, b), (full_h, full_c) = lstm_full_launch(kx, h, cuda_device)
    if rows == "ragged":
        rows = x.shape[0] - 29
    part_h, part_c = lstm.lstm_cell(x[:rows], h0[:rows], c0[:rows], w, b)
    assert torch.equal(part_h, full_h[:rows]) and torch.equal(part_c, full_c[:rows]), rows


@pytest.fixture(scope="module")
def fsn_pcm():
    """Four 6.0 s streams of noisy speech as int16 (the benchmark's mixes)."""
    import sys

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from benchmark import audio

    bank = audio.Bank(REPO, "cpu")
    plan = audio.Plan(np.random.default_rng(7), 4, bank.length)
    mix = audio.mix_blocks(bank, plan, 375 * 256).numpy()
    return np.clip(np.round(mix * 32768.0), -32768, 32767).astype(np.int16)


def _fsn_process(pcm, device):
    k = koala_tpu_torch.create(ACCESS_KEY, model_path=FSN_MODEL, device=device)
    try:
        return np.concatenate([k.process(pcm[s:s + 256]) for s in range(0, len(pcm), 256)])
    finally:
        k.delete()


@pytest.mark.cuda
def test_fullsubnet_process_equals_its_row_of_the_corpus_runner(cuda_device, fsn_pcm):
    """One stream's Koala.process, frame by frame (1 and 257 kernel rows),
    is bit for bit its row of CorpusRunner.enhance_batch at B = 64 (64 and
    16448 rows)."""
    from koala_tpu_torch.ops.kernels import lstm
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    batch = np.zeros((64, 375 * 256), np.float32)
    batch[:4] = fsn_pcm / 32768.0
    batch[4:] = np.roll(batch[:4], 1000, axis=1).repeat(15, axis=0)
    runner = CorpusRunner(FSN_MODEL, global_batch=64, utterance_samples=375 * 256,
                          mesh=make_mesh(["gpu:0"]))
    before = lstm.launches
    out = runner.enhance_batch(batch)
    torch.cuda.synchronize()
    assert lstm.launches - before == 4 * 375
    rows = np.clip(np.round(out[:2].reshape(2, -1).cpu().numpy().astype(np.float64) * 32768.0),
                   -32768, 32767).astype(np.int16)
    for s in range(2):
        assert np.array_equal(_fsn_process(fsn_pcm[s], "gpu"), rows[s]), s


@pytest.mark.cuda
def test_fullsubnet_server_equals_process(cuda_device, fsn_pcm):
    """The StreamingServer's rounds (full chunks through the sequence, the
    rest through the captured step graph) against Koala.process, bit for bit."""
    import time

    from koala_tpu_torch.serve import StreamingServer

    pcm = fsn_pcm[:, :100 * 256]
    want = [_fsn_process(row, "gpu") for row in pcm]
    server = StreamingServer(ACCESS_KEY, model_path=FSN_MODEL, device="gpu", num_streams=4,
                             chunk_frames=8)
    try:
        for s in range(4):
            server.push(s, pcm[s, :(37 + 13 * s) * 256])
        time.sleep(0.5)
        for s in range(4):
            server.push(s, pcm[s, (37 + 13 * s) * 256:])
        for s in range(4):
            got, deadline = [], time.time() + 120
            while sum(len(g) for g in got) < pcm.shape[1] and time.time() < deadline:
                chunk = server.pull(s)
                if len(chunk):
                    got.append(chunk)
                else:
                    time.sleep(0.005)
            assert np.array_equal(np.concatenate(got), want[s]), s
    finally:
        server.close()


# -- Demucs and the LSTM kernel at depth 2048 -----------------------------------

# Demucs's layer-step: kx 1024 + H 1024, whose A tile the kernel holds in
# K-panels; the same tolerance as FullSubNet's widths (sums of 2048 terms in
# the tensor cores' order against the library's still differ by about 1e-6)
DEMUCS_LSTM = (1024, 1024)


@pytest.fixture
def demucs_lstm_launch(cuda_device):
    """Demucs's layer-step case at 4096 rows and its h', c' from one launch."""
    from koala_tpu_torch.ops.kernels import lstm

    case = _lstm_case(*DEMUCS_LSTM, 4096, cuda_device)
    return case, lstm.lstm_cell(*case)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 64, 2048])
def test_lstm_kernel_at_depth_2048_matches_its_plain_version(cuda_device, rows):
    from koala_tpu_torch.ops.kernels import lstm

    assert lstm.tile_rows(*DEMUCS_LSTM) == 64 and lstm.tile_depth(*DEMUCS_LSTM) == 1024
    x, h0, c0, w, b = _lstm_case(*DEMUCS_LSTM, rows, cuda_device)
    before = lstm.launches
    out_h, out_c = lstm.lstm_cell(x, h0, c0, w, b)
    torch.cuda.synchronize()
    assert lstm.launches == before + 1
    ref_h, ref_c = lstm.lstm_cell_ref(x, h0, c0, w, b)
    assert (out_h - ref_h).abs().max() < LSTM_ATOL
    assert (out_c - ref_c).abs().max() < LSTM_ATOL
    assert torch.isfinite(out_h).all() and float(out_h.abs().max()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 64, 129, 2048])
def test_lstm_kernel_at_depth_2048_gives_a_row_the_same_bits_at_any_row_count(
        cuda_device, demucs_lstm_launch, rows):
    from koala_tpu_torch.ops.kernels import lstm

    (x, h0, c0, w, b), (full_h, full_c) = demucs_lstm_launch
    part_h, part_c = lstm.lstm_cell(x[:rows], h0[:rows], c0[:rows], w, b)
    assert torch.equal(part_h, full_h[:rows]) and torch.equal(part_c, full_c[:rows]), rows


@pytest.fixture(scope="module")
def demucs_model(tmp_path_factory):
    """dns64's configuration at its published widths, its weights drawn from
    the seed at load (the file holds the placeholder)."""
    import json
    import sys

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    with open(os.path.join(REPO, "benchmark", "configs", "demucs-dns64.json")) as f:
        cfg = json.load(f)["model"]
    path = str(tmp_path_factory.mktemp("demucs") / "dns64.pv")
    params_io.save_params(path, {"empty": np.zeros((1,), np.float32)}, cfg)
    return path, cfg


@pytest.mark.cuda
def test_demucs_step_equals_sequence_on_the_card(cuda_device, demucs_model, fsn_pcm):
    """Two streams at dns64's widths: Engine.step hop by hop, a sequence cut
    into calls of 1, 3 and 7 hops, and one call give the same bits."""
    from koala_tpu_torch.engine.stream import load_model

    eng, params = load_model(demucs_model[0], cuda_device)
    hops = torch.as_tensor(fsn_pcm[:2, :24 * 256] / 32768.0, dtype=torch.float32,
                           device=cuda_device).reshape(2, 24, 256)
    with torch.inference_mode():
        _, whole = eng.sequence(params, eng.init_state((2,), cuda_device), hops)
        for cut in (1, 3, 7):
            st, parts = eng.init_state((2,), cuda_device), []
            for lo in range(0, 24, cut):
                st, o = eng.sequence(params, st, hops[:, lo:lo + cut])
                parts.append(o)
            assert torch.equal(torch.cat(parts, dim=1), whole), cut
        st, steps = eng.init_state((2,), cuda_device), []
        for t in range(24):
            st, o = eng.step(params, st, hops[:, t])
            steps.append(o)
    assert torch.equal(torch.stack(steps, dim=1), whole)
    assert float(whole[:, :3].abs().max()) == 0.0 and float(whole[:, 3:].abs().max()) > 0


@pytest.mark.cuda
def test_demucs_runner_matches_the_reference(cuda_device, demucs_model, fsn_pcm, monkeypatch):
    """CorpusRunner at B = 4 x 6.0 s, dns64's widths, against the benchmark's
    plain reference at bf16 products: its pooled err_rms under the cell's
    limit, and one LSTM launch a layer and hop."""
    import json

    from benchmark import compare
    from benchmark.reference import demucs as ref
    from koala_tpu_torch.ops.kernels import lstm
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    path, cfg = demucs_model
    batch = (fsn_pcm / 32768.0).astype(np.float32)
    runner = CorpusRunner(path, global_batch=4, utterance_samples=375 * 256,
                          mesh=make_mesh(["gpu:0"]))
    before = lstm.launches
    out = runner.enhance_batch(batch)
    torch.cuda.synchronize()
    assert lstm.launches - before == 2 * 375
    hops = torch.as_tensor(batch, device=cuda_device).reshape(4, 375, 256)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    want = ref.Reference({"model": cfg}, path, cuda_device).enhance(
        hops, {"products": "bfloat16", "resample": "float32"})
    parts = [compare.errors(o, r) for o, r in zip(out.cpu().numpy(), want.cpu().numpy())]
    err = float(np.sqrt(sum(p[0] for p in parts) / sum(p[1] for p in parts)))
    with open(os.path.join(REPO, "benchmark", "cells", "demucs-dns64.wash.b2048.json")) as f:
        limit = json.load(f)["limits"]["err_rms"]
    print("demucs runner err_rms %.4g (limit %g)" % (err, limit))
    assert err < limit


@pytest.mark.cuda
def test_demucs_server_equals_process(cuda_device, demucs_model, fsn_pcm):
    """The StreamingServer's rounds (full chunks through the sequence, the
    rest through the captured step graph) against Koala.process, bit for bit,
    at dns64's widths; both report the 768-sample delay."""
    import time

    from koala_tpu_torch.serve import StreamingServer

    path = demucs_model[0]
    pcm = fsn_pcm[:2, :40 * 256]
    k = koala_tpu_torch.create(ACCESS_KEY, model_path=path, device="gpu")
    try:
        assert k.delay_sample == 768
        want = []
        for row in pcm:
            k.reset()
            want.append(np.concatenate([k.process(row[s:s + 256])
                                        for s in range(0, len(row), 256)]))
    finally:
        k.delete()
    server = StreamingServer(ACCESS_KEY, model_path=path, device="gpu", num_streams=2,
                             chunk_frames=8)
    try:
        assert server.delay_sample == 768
        for s in range(2):
            server.push(s, pcm[s, :(13 + 7 * s) * 256])
        time.sleep(0.5)
        for s in range(2):
            server.push(s, pcm[s, (13 + 7 * s) * 256:])
        for s in range(2):
            got, deadline = [], time.time() + 120
            while sum(len(g) for g in got) < pcm.shape[1] and time.time() < deadline:
                chunk = server.pull(s)
                if len(chunk):
                    got.append(chunk)
                else:
                    time.sleep(0.005)
            assert np.array_equal(np.concatenate(got), want[s]), s
    finally:
        server.close()


# -- Demucs's fused U-Net: rowmm's fused entry and the overlap pass ---------------

# (name, K, N, form) of dns64's 20 products: each level's strided convolution
# (bias, ReLU, rounded: its operand rounded on load), its 1x1 (GLU, f32 into
# the skip buffer), the decoder's 1x1 (GLU, rounded) and transposed
# convolution (the plain product, then the overlap pass)
DNS64_CH = (1, 64, 128, 256, 512, 1024)
DNS64_PRODUCTS = [p for k in range(1, 6) for p in (
    ("enc%d" % k, 8 * DNS64_CH[k - 1], DNS64_CH[k], "conv"),
    ("enc%d.glu" % k, DNS64_CH[k], 2 * DNS64_CH[k], "glu"),
    ("dec%d.glu" % k, DNS64_CH[k], 2 * DNS64_CH[k], "glu_round"),
    ("dec%d.t" % k, DNS64_CH[k], 8 * DNS64_CH[k - 1], "tail"))]


def _bf16(t):
    return t.bfloat16().float()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 63, 1025, 16384])
@pytest.mark.parametrize("name,k,n,form", DNS64_PRODUCTS, ids=[p[0] for p in DNS64_PRODUCTS])
def test_demucs_fused_forms_match_the_composition(cuda_device, name, k, n, form, rows):
    """Each of dns64's products at 1, 63, 1025 and 16384 rows: the fused
    kernel that ``fused_plan`` picks (the narrow kernels at 1 and 63, the
    tile at 1025 and 16384) against the plain rowmm and the PyTorch ops it
    stands for, bit for bit; the strided convolution's A a
    window of overlapping rows over f32 values, the encoder's GLU into a
    slice of a skip buffer; the transposed convolution's overlap pass
    against its PyTorch composition, with a carry and a skip buffer's slice."""
    from koala_tpu_torch.ops.kernels import overlap

    lead = (2, rows // 2) if rows % 2 == 0 else (1, rows)
    w = _bf16(_randn(k + n, (k, n), 1.0 / np.sqrt(k), cuda_device))
    bias = _randn(n, (n,), 0.3, cuda_device)
    if form == "conv":
        c_in = k // 8
        base = _randn(rows, (lead[0], 4 * lead[1] + 4, c_in), 1.0, cuda_device)
        a = base.as_strided(lead + (k,), (base.stride(0), 4 * c_in, 1))
    else:
        a = _bf16(_randn(rows + k, lead + (k,), 1.0, cuda_device))
    before = rowmm.fused_launches
    if form == "conv":
        got = rowmm.launch_fused(a, w, bias, torch.empty(lead + (n,), device=cuda_device),
                                 relu=True, round_a=True, round_out=True)
        want = rowmm.fused_ref(a, w, bias, torch.empty_like(got), True, False, True, True)
    elif form.startswith("glu"):
        buf = torch.full((lead[0], lead[1] + 5, n // 2), -3.0, device=cuda_device)
        rnd = form == "glu_round"
        got = rowmm.launch_fused(a, w, bias, buf[:, 5:], glu=True, round_out=rnd)
        want = rowmm.fused_ref(a, w, bias, torch.empty_like(got), False, True, False, rnd)
        assert float(buf[:, :5].max()) == -3.0 and float(buf[:, :5].min()) == -3.0
    else:
        p = rowmm.rowmm(a, w).view(lead + (2, 4, n // 8))
        c_out, last = n // 8, name == "dec1.t"
        carry = _randn(7, (lead[0], 4, c_out), 0.5, cuda_device)
        skip = None if last else _randn(8, (lead[0], 4 * lead[1] + 9, c_out), 0.5,
                                        cuda_device)[:, :4 * lead[1]]
        b = bias[:c_out].contiguous()
        got, got_carry = overlap.overlap_add(p, carry, b, not last, skip, not last)
        want, want_carry = overlap.overlap_add_ref(p, carry, b, not last, skip, not last)
        assert torch.equal(got_carry, want_carry)
    torch.cuda.synchronize()
    assert rowmm.fused_launches == before + (form != "tail")
    assert got.shape == want.shape and torch.equal(got, want), name
    assert float(got.abs().max()) > 0


@pytest.mark.cuda
def test_fused_sigmoid_is_torchs(cuda_device):
    """The GLU epilogue's sigmoid and product against torch's, bit for bit,
    over 2**22 finite floats spread over every exponent, in each fused
    kernel: A [M, 1] of the values and B of ones, so that value and gate are
    the value itself."""
    bits = torch.arange(0, 2 ** 32, 1024, dtype=torch.int64).to(torch.int32)
    x = bits.view(torch.float32)
    x = x[torch.isfinite(x)].to(cuda_device).reshape(-1, 1)
    w = torch.ones((1, 64), device=cuda_device)
    b = torch.zeros((64,), device=cuda_device)
    want = rowmm.fused_ref(x, w, b, torch.empty((x.shape[0], 32), device=cuda_device), False,
                           True, False, False)
    for variant in range(len(rowmm.FUSED_VARIANTS)):
        got = rowmm.launch_fused(x, w, b, torch.empty_like(want), glu=True, variant=variant)
        torch.cuda.synchronize()
        differ = (got.view(torch.int32) != want.view(torch.int32)).any(dim=1)
        assert not bool(differ.any()), (variant, x[differ][:8].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("glu", [False, True])
def test_fused_entry_writes_unaligned_rows(cuda_device, glu):
    """Output rows that are not 16-byte aligned take the 4-byte stores: the
    same bits, nothing written outside them, in each fused kernel."""
    k, n, m = 64, 128, 3000
    a = _bf16(_randn(1, (m, k), 1.0, cuda_device))
    w = _bf16(_randn(2, (k, n), 0.1, cuda_device))
    bias = _randn(3, (n,), 0.3, cuda_device)
    width = n // 2 if glu else n
    want = rowmm.fused_ref(a, w, bias, torch.empty((m, width), device=cuda_device), not glu, glu,
                           False, True)
    for variant in range(len(rowmm.FUSED_VARIANTS)):
        flat = torch.full((m * width + 2,), 5.0, device=cuda_device)
        got = rowmm.launch_fused(a, w, bias, flat[1:-1].view(m, width), relu=not glu, glu=glu,
                                 round_out=True, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and float(flat[0]) == 5.0 and float(flat[-1]) == 5.0, \
            variant


@pytest.mark.cuda
def test_demucs_fused_runner_batch_is_the_plain_paths(cuda_device, demucs_model, fsn_pcm,
                                                      monkeypatch):
    """A CorpusRunner batch at dns64's widths (4 x 6.0 s, one block of 375
    hops): the fused path's output bit for bit the plain path's
    (``_encoder_plain``, ``_decoder_plain``); 15 fused launches and 5 overlap
    passes a block, no plain version of the fused entry."""
    from koala_tpu_torch.models import demucs
    from koala_tpu_torch.ops.kernels import overlap
    from koala_tpu_torch.parallel import CorpusRunner, make_mesh

    path, _ = demucs_model
    batch = (fsn_pcm / 32768.0).astype(np.float32)
    runner = CorpusRunner(path, global_batch=4, utterance_samples=375 * 256,
                          mesh=make_mesh(["gpu:0"]))
    runner.enhance_batch(batch)
    plain_calls = []
    monkeypatch.setattr(rowmm, "fused_ref", lambda *a: plain_calls.append(1))
    fused, tails = rowmm.fused_launches, overlap.launches
    out = runner.enhance_batch(batch).clone()
    torch.cuda.synchronize()
    assert rowmm.fused_launches - fused == 15 and overlap.launches - tails == 5
    assert not plain_calls
    monkeypatch.undo()
    monkeypatch.setattr(demucs, "_encoder", demucs._encoder_plain)
    monkeypatch.setattr(demucs, "_decoder", demucs._decoder_plain)
    fused = rowmm.fused_launches
    plain = runner.enhance_batch(batch)
    torch.cuda.synchronize()
    assert rowmm.fused_launches == fused
    assert torch.equal(out, plain) and float(out.abs().max()) > 0


DNS64_FUSED = [p for p in DNS64_PRODUCTS if p[3] != "tail"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [0, 1, 2], ids=["narrow4", "narrow16", "tile"])
@pytest.mark.parametrize("name,k,n,form", DNS64_FUSED, ids=[p[0] for p in DNS64_FUSED])
def test_every_fused_variant_matches_the_composition(cuda_device, name, k, n, form, variant):
    """Each fused kernel, whatever ``fused_plan`` would pick, at each of
    dns64's fused products and at 1, 5, 63, 300 and 1100 rows (a partial
    block of every variant): bit for bit the plain rowmm and the PyTorch
    ops, the strided convolution's A a window over f32 values rounded on
    load, the GLUs into a slice of a larger buffer."""
    w = _bf16(_randn(k + n, (k, n), 1.0 / np.sqrt(k), cuda_device))
    bias = _randn(n, (n,), 0.3, cuda_device)
    for rows in (1, 5, 63, 300, 1100):
        if form == "conv":
            base = _randn(rows, (1, 4 * rows + 4, k // 8), 1.0, cuda_device)
            a = base.as_strided((1, rows, k), (base.stride(0), k // 2, 1))
            got = rowmm.launch_fused(a, w, bias, torch.empty((1, rows, n), device=cuda_device),
                                     relu=True, round_a=True, round_out=True, variant=variant)
            want = rowmm.fused_ref(a, w, bias, torch.empty_like(got), True, False, True, True)
        else:
            a = _bf16(_randn(rows + k, (1, rows, k), 1.0, cuda_device))
            buf = torch.full((1, rows + 3, n // 2), -3.0, device=cuda_device)
            rnd = form == "glu_round"
            got = rowmm.launch_fused(a, w, bias, buf[:, 3:], glu=True, round_out=rnd,
                                     variant=variant)
            want = rowmm.fused_ref(a, w, bias, torch.empty_like(got), False, True, False, rnd)
            assert float(buf[:, :3].abs().max()) == 3.0 and float(buf[:, :3].max()) == -3.0
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, rows)
        assert float(got.abs().max()) > 0


@pytest.mark.cuda
def test_demucs_one_streams_hops_take_the_fused_kernels(cuda_device, demucs_model, fsn_pcm,
                                                         monkeypatch):
    """One stream's Engine.step at dns64's widths, hop by hop (256 rows at
    level 1 down to one at level 5): 15 launches of the fused entry and 5
    overlap passes a hop, never its plain version; bit for bit the same hops
    through the plain U-Net (``_encoder_plain``, ``_decoder_plain``)."""
    from koala_tpu_torch.engine.stream import load_model
    from koala_tpu_torch.models import demucs
    from koala_tpu_torch.ops.kernels import overlap

    eng, params = load_model(demucs_model[0], cuda_device)
    hops = torch.as_tensor(fsn_pcm[:1, :12 * 256] / 32768.0, dtype=torch.float32,
                           device=cuda_device).reshape(1, 12, 256)

    def run():
        st, outs = eng.init_state((1,), cuda_device), []
        with torch.inference_mode():
            for t in range(hops.shape[1]):
                st, o = eng.step(params, st, hops[:, t])
                outs.append(o)
        torch.cuda.synchronize()
        return torch.stack(outs, dim=1)

    plain_calls = []
    real_ref = rowmm.fused_ref
    monkeypatch.setattr(rowmm, "fused_ref", lambda *a: plain_calls.append(1) or real_ref(*a))
    fused, tails = rowmm.fused_launches, overlap.launches
    out = run()
    assert rowmm.fused_launches - fused == 15 * 12 and overlap.launches - tails == 5 * 12
    assert not plain_calls
    monkeypatch.setattr(demucs, "_encoder", demucs._encoder_plain)
    monkeypatch.setattr(demucs, "_decoder", demucs._decoder_plain)
    fused = rowmm.fused_launches
    plain = run()
    assert rowmm.fused_launches == fused
    assert torch.equal(out, plain) and float(out[:, 3:].abs().max()) > 0
