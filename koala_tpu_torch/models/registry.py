"""Model registry: maps a model ``kind`` (from the model file's config) to
its implementation, behind one contract:

    init_state(batch_shape, config, device)       -> state tree
    step(params, state, re, im, config)           -> (state', mask)
    apply_sequence(params, state, re, im, config) -> (state', masks)

Families ported so far: ``mask_gru`` (the flagship) and ``identity``.
"""

from __future__ import annotations

from typing import Any, Dict

from ..errors import ERROR_STACK, KoalaKeyError, raise_with_stack
from . import identity, mask_gru

MODEL_REGISTRY: Dict[str, Any] = {
    "mask_gru": mask_gru,
    "identity": identity,
}


def get_model(kind: str):
    if kind not in MODEL_REGISTRY:
        ERROR_STACK.push("unknown model kind `%s` (available: %s)"
                         % (kind, ", ".join(sorted(MODEL_REGISTRY))))
        raise_with_stack(KoalaKeyError, "Unknown model kind")
    return MODEL_REGISTRY[kind]


__all__ = ["MODEL_REGISTRY", "get_model"]
