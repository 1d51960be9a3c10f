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
