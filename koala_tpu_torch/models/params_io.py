"""Model parameter files (save/load) and numpy <-> torch carriers.

The same ``.pv`` container as the JAX package's ``models/params_io.py``, so
both packages load one file:

- key ``__meta__``: uint8 bytes of a JSON header {magic, version, config}
- tensor keys: flattened tree paths (``gru/0/wx``), stored float16 and loaded
  back as float32.

``params_from_numpy`` turns a parameter tree of numpy arrays (from
``load_params`` or exported from the JAX package) into the port's module,
``params_to_numpy`` turns the module back into that tree;
``state_from_numpy`` / ``state_to_numpy`` carry engine state the same way.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .._version import __version__
from ..constants import MODEL_MAGIC
from ..errors import ERROR_STACK, KoalaIOError, raise_with_stack
from .registry import get_model, kind_of, reconcile_config


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        # a list's items are 0 .. n-1; other digit names (a Sequential's
        # layers with weights, "0" and "2") stay a dict
        if keys and set(keys) == {str(i) for i in range(len(keys))}:
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def params_to_numpy(params):
    """A parameter module -> tree of numpy arrays (the inverse of
    ``params_from_numpy``; the layout both packages save and load). A tree is
    passed through."""
    if isinstance(params, torch.nn.Module):
        return _unflatten({k.replace(".", "/"): v.detach().cpu().numpy()
                           for k, v in params.state_dict().items()})
    return params


def save_params(path: str, params, config: Dict[str, Any]) -> None:
    """Write a parameter module or tree with its fully resolved config."""
    tree = params_to_numpy(params)
    config = reconcile_config(config, tree)
    flat = _flatten(tree)
    meta = json.dumps({
        "magic": MODEL_MAGIC.decode("ascii", "replace").rstrip("\x00"),
        "version": __version__,
        "config": config,
    }).encode("utf-8")
    arrays = {"__meta__": np.frombuffer(meta, dtype=np.uint8)}
    for k, v in flat.items():
        v = np.asarray(v)
        arrays[k] = v.astype(np.float16) if v.dtype == np.float32 else v
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_params(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Load a model file -> (params tree of float32 numpy arrays, config)."""
    if not os.path.exists(path):
        ERROR_STACK.push("could not find model file at `%s`" % path)
        raise_with_stack(KoalaIOError, "IO error")
    try:
        with np.load(path, allow_pickle=False) as data:
            if "__meta__" not in data:
                raise ValueError("missing __meta__ header")
            meta = json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))
            expected_magic = MODEL_MAGIC.decode("ascii", "replace").rstrip("\x00")
            if meta.get("magic") != expected_magic:
                raise ValueError("bad magic %r" % meta.get("magic"))
            flat = {}
            for k in data.files:
                if k == "__meta__":
                    continue
                v = data[k]
                flat[k] = v.astype(np.float32) if v.dtype == np.float16 else v
    except (ValueError, OSError, KeyError, json.JSONDecodeError) as e:
        ERROR_STACK.push("failed to parse model file `%s`: %s" % (path, e))
        ERROR_STACK.push("model load failed")
        raise_with_stack(KoalaIOError, "Invalid model file")
    params, config = _unflatten(flat), meta["config"]
    try:
        # legacy files predate some of a config's switches: the weights decide
        config = reconcile_config(config, params)
    except (ValueError, KeyError, TypeError) as e:
        ERROR_STACK.push("incompatible model file `%s`: %s" % (path, e))
        raise_with_stack(KoalaIOError, "Invalid model file")
    return params, config


def default_model_path() -> str:
    """Path of the bundled trained model (``models/koala_params_tpu.pv``)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(here), "models", "koala_params_tpu.pv")


def params_from_numpy(tree, device, kind: str = None, config=None) -> torch.nn.Module:
    """Parameter tree of numpy arrays -> the port's parameter module on
    ``device``: the ``Params`` of ``kind``, the model file's
    (``config["kind"]``); without it, the kind the tree's layout implies
    (``registry.kind_of``). A kind's ``params_from_tree`` makes it from the
    tree and the file's ``config`` where it has one (a seeded draw)."""
    model = get_model(kind or kind_of(None, tree))
    build = getattr(model, "params_from_tree", None)
    params = build(tree, config) if build is not None else model.Params(tree)
    return params.to(torch.device(device))


def state_from_numpy(tree, device):
    """Engine-state tree of numpy arrays -> the same tree of float32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=torch.device(device))


def state_to_numpy(tree):
    """Engine-state tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


__all__ = ["save_params", "load_params", "default_model_path",
           "params_from_numpy", "params_to_numpy", "state_from_numpy", "state_to_numpy"]
