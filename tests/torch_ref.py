"""Shared helpers of the koala_tpu_torch tests: weights and inputs made once
and handed to both packages as numpy arrays (the JAX package is the
reference)."""

import numpy as np
import pytest
import torch

# keep the port's CPU tests light beside the suite's other workers
torch.set_num_threads(2)

ACCESS_KEY = "TESTKEY0" * 2


def jax_params(cfg, seed):
    """koala_tpu mask_gru weights from PRNGKey(seed), as a numpy tree."""
    import jax

    from koala_tpu.models import mask_gru

    params = mask_gru.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def to_numpy(tree):
    """JAX or torch tree -> numpy tree."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return np.asarray(tree, np.float32) if np.asarray(tree).dtype != np.float32 \
        else np.asarray(tree)


def flat_tree(tree, prefix=""):
    """A JAX-layout tree (parameters or their gradients) -> {name: float64
    numpy array} under the port's ``named_parameters`` names (``gru.0.wx``),
    so both packages' leaves pair up by name."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tree(v, "%s%s." % (prefix, k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_tree(v, "%s%d." % (prefix, i)))
    else:
        out[prefix[:-1]] = np.asarray(tree, np.float64)
    return out


def rel_err(ref, x):
    """|x - ref| / |ref| in the 2-norm, float64."""
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-30))


def snr_db(ref, x):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(x, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30))


# the evaluation harness's figures, the port's against koala_tpu's on the
# same pair: the enhanced int16 streams differ by at most 2 LSB, so RMS
# deviations within 1e-4 (2 LSB is 6e-5 of full scale), SI-SDR and fwSNRseg
# within 0.05 dB, STOI within 1e-3, and the input's own metrics as good as
# exact
EVALUATE_TOL = {"dev_pure_speech": 1e-4, "dev_pure_noise": 1e-4, "dev_mixed": 1e-4,
                "si_sdr_mixed_db": 0.05, "si_sdr_input_db": 1e-9, "si_sdr_gain_db": 0.05,
                "stoi_mixed": 1e-3, "stoi_input": 1e-12, "fwsnrseg_mixed": 0.05,
                "fwsnrseg_input": 1e-9}


def assert_evaluate_near_jax(got, want):
    """``got`` (the port's ``evaluate``) key by key within ``EVALUATE_TOL``
    of ``want`` (koala_tpu's)."""
    assert set(got) == set(want) == set(EVALUATE_TOL)
    for key, tol in EVALUATE_TOL.items():
        assert abs(got[key] - want[key]) <= tol, (key, got[key], want[key])


def assert_near_jax(got, want):
    """Within 2 int16 LSB of koala_tpu's output (tests/test_serve.py's bound
    between a batched pool and a single stream), save a handful of samples
    at 3 LSB: at most 0.1% of them, and at least 2. Across packages the
    float32 sums run in another order, and an input can sit where that flips
    a bfloat16 rounding of a product operand: on the bundled model and one of
    tests/test_torch_serve.py's draws, koala_tpu's own process_chunk and
    process differ by 3 LSB on 34 of 2048 samples, and the port's pool lands
    on 2 samples at 3 LSB."""
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 3, diff.max()
    assert np.count_nonzero(diff > 2) <= max(2, len(diff) // 1000), np.count_nonzero(diff > 2)


@pytest.fixture
def cuda_device():
    """The CUDA card; tests marked ``cuda`` skip where there is none (decided
    here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class RecordingOptimizer:
    """Wraps an optimizer and keeps a copy of the gradients that each
    ``step`` applies (before the optimizer's own clipping)."""

    def __init__(self, inner):
        self.inner = inner
        self.grads = []

    def zero_grad(self):
        self.inner.zero_grad()

    def step(self):
        self.grads.append([p.grad.detach().clone() for p in self.inner.params])
        self.inner.step()


def data_parallel_worker(rank, world, port, tree, cfg, noisy, clean, steps, out_path):
    """One process of a data-parallel run on the CPU (gloo): ``steps``
    train steps over the global batch with a mesh of one CPU device; writes
    the losses, the first step's averaged gradients and the parameters at
    the end to ``out_path % rank``."""
    import torch.distributed as dist

    from koala_tpu_torch.models.params_io import params_from_numpy
    from koala_tpu_torch.parallel import make_mesh
    from koala_tpu_torch.train.train import make_optimizer, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            rank=rank, world_size=world)
    try:
        params = params_from_numpy(tree, "cpu").requires_grad_(True)
        opt = RecordingOptimizer(make_optimizer(params, 1e-3, 10))
        step = make_train_step(cfg, opt, mesh=make_mesh(["cpu"]))
        losses = [float(step(params, torch.as_tensor(noisy), torch.as_tensor(clean)))
                  for _ in range(steps)]
        names = [n for n, _ in params.named_parameters()]
        np.savez(out_path % rank, losses=np.asarray(losses),
                 **{"grad/" + n: g.numpy() for n, g in zip(names, opt.grads[0])},
                 **{"param/" + n: p.detach().numpy() for n, p in params.named_parameters()})
    finally:
        dist.destroy_process_group()


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
