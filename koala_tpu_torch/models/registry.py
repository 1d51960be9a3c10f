"""Model registry: maps a model ``kind`` (from the model file's config) to
its implementation, behind one contract:

    init_state(batch_shape, config, device)       -> state tree
    step(params, state, re, im, config)           -> (state', mask)
    apply_sequence(params, state, re, im, config) -> (state', masks)

A mask is a tensor (real) or a pair (mask_re, mask_im) (complex; the
engine's ``apply_mask``). Families: ``mask_gru`` (the flagship), ``mmse``
(the parameter-free baseline), ``fullsubnet`` (FullSubNet, a full-band and a
sub-band LSTM with a complex mask) and ``identity``.
"""

from __future__ import annotations

from typing import Any, Dict

from ..errors import ERROR_STACK, KoalaKeyError, raise_with_stack
from . import fullsubnet, identity, mask_gru, mmse

MODEL_REGISTRY: Dict[str, Any] = {
    "mask_gru": mask_gru,
    "mmse": mmse,
    "fullsubnet": fullsubnet,
    "identity": identity,
}


def get_model(kind: str):
    if kind not in MODEL_REGISTRY:
        ERROR_STACK.push("unknown model kind `%s` (available: %s)"
                         % (kind, ", ".join(sorted(MODEL_REGISTRY))))
        raise_with_stack(KoalaKeyError, "Unknown model kind")
    return MODEL_REGISTRY[kind]


__all__ = ["MODEL_REGISTRY", "get_model"]
