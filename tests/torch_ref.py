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


@pytest.fixture
def cuda_device():
    """The CUDA card; tests marked ``cuda`` skip where there is none (decided
    here, at run time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
