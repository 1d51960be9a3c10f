"""Model registry: the one table of model kinds. A model file's config names
its ``kind`` (``kind_of``); each kind is one module of ``models/`` with

    Params(tree), init_params(generator, config)  -> parameter module
    init_state(batch_shape, config, device)       -> state tree
    step(params, state, re, im, config)           -> (state', mask)
    apply_sequence(params, state, re, im, config) -> (state', masks)

and, where it needs them, ``normalize_config(config, tree)`` (the config
reconciled with its weights), ``fused_hops(params, config, hops)`` (the
leading hops that ``Engine.sequence_fast`` sends through the fused engine
kernel) and ``params_from_tree(tree, config)`` (the parameter module of a
model file's tree, where ``Params(tree)`` is not it). A mask is a tensor
(real) or a pair (mask_re, mask_im) (complex; the engine's ``apply_mask``).

A module that declares ``domain = "waveform"`` takes and returns hops, with
its own analysis and synthesis in place of the engine's STFT:

    step(params, state, hop, config)              -> (state', out hop [*, 256])
    apply_sequence(params, state, hops, config)   -> (state', out hops [*, T, 256])

``delay_hops(config)``, where a module declares it, is the hops its output
lags its input (``Engine.delay_sample`` = 256 x it; one hop where it is not
declared). Kinds: ``mask_gru`` (the flagship), ``mmse`` (the parameter-free
baseline), ``fullsubnet`` (FullSubNet, a full-band and a sub-band LSTM with
a complex mask), ``demucs`` (denoiser's causal Demucs, a waveform U-Net with
an LSTM, 3 hops of delay) and ``identity``.
"""

from __future__ import annotations

from typing import Any, Dict

from ..errors import ERROR_STACK, KoalaKeyError, raise_with_stack
from . import demucs, fullsubnet, identity, mask_gru, mmse

MODEL_REGISTRY: Dict[str, Any] = {
    "mask_gru": mask_gru,
    "mmse": mmse,
    "fullsubnet": fullsubnet,
    "demucs": demucs,
    "identity": identity,
}

# the kind of a legacy model file, whose config names none
DEFAULT_KIND = "mask_gru"


def get_model(kind: str):
    if kind not in MODEL_REGISTRY:
        ERROR_STACK.push("unknown model kind `%s` (available: %s)"
                         % (kind, ", ".join(sorted(MODEL_REGISTRY))))
        raise_with_stack(KoalaKeyError, "Unknown model kind")
    return MODEL_REGISTRY[kind]


def kind_of(config, tree=None) -> str:
    """The model kind of a config (``DEFAULT_KIND`` where it names none).
    Given only a parameter ``tree``, the kind its layout implies: a tree with
    a ``gru`` key is the default kind's, one with only the placeholder leaf
    an identity model's (mmse has the same one: pass its config)."""
    if config is None and tree is not None:
        return DEFAULT_KIND if "gru" in tree else "identity"
    return (config or {}).get("kind", DEFAULT_KIND)


def reconcile_config(config, tree):
    """A model file's config reconciled with its weights by its kind's
    ``normalize_config``; the config as it is for a kind without one."""
    normalize = getattr(MODEL_REGISTRY.get(kind_of(config)), "normalize_config", None)
    return config if normalize is None else normalize(config, tree)


__all__ = ["MODEL_REGISTRY", "DEFAULT_KIND", "get_model", "kind_of", "reconcile_config"]
