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
    sequence engine (floor + GRU kernels), near process_chunk on the card."""
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
    assert snr_db(ref.astype(np.float64), got.reshape(streams, -1).astype(np.float64)) > 35.0


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
    bits that the same steps made eagerly on the card leave."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench_torch

    engine, params = bench_torch.load_engine(cuda_device)
    hop = _randn(12, (256,), 0.05, cuda_device)
    with torch.inference_mode():
        chain = bench_torch.StepChain(engine, params, engine.init_state((), cuda_device),
                                      hop.clone())
        assert chain.graph is not None
        chain.run(40)
        state, out = engine.init_state((), cuda_device), hop
        for _ in range(40):
            state, out = engine.step(params, state, out)
    torch.cuda.synchronize()
    assert torch.equal(chain.hop, out)
    for k in ("input_carry", "ola"):
        assert torch.equal(chain.state[k], state[k])
    for k in ("h", "floor"):
        assert torch.equal(chain.state["model"][k], state["model"][k])
