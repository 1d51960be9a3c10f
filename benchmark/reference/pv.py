"""Reader of the `.pv` model container, independent of the program.

A `.pv` file is a numpy `.npz` archive: the key `__meta__` holds the UTF-8
bytes of a JSON header (`magic`, `version`, `config`), every other key is a
tensor under its flattened tree path (`gru/0/wx`), stored as float16.
"""

from __future__ import annotations

import json

import numpy as np

MAGIC = "KOALATPU1"


def read_pv(path):
    """-> (flat {path: float32 array}, config dict)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))
        if meta.get("magic") != MAGIC:
            raise ValueError("%s: not a model file (magic %r)" % (path, meta.get("magic")))
        flat = {k: np.asarray(data[k], np.float32) for k in data.files if k != "__meta__"}
    return flat, meta["config"]


def write_pv(path, flat, config, version="bench"):
    """Write a model file: `flat` {path: array} stored as float16."""
    meta = json.dumps({"magic": MAGIC, "version": version, "config": config}).encode("utf-8")
    arrays = {"__meta__": np.frombuffer(meta, dtype=np.uint8)}
    arrays.update({k: np.asarray(v, np.float32).astype(np.float16) for k, v in flat.items()})
    with open(path, "wb") as f:
        np.savez(f, **arrays)
