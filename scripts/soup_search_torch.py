"""Weight-soup search over sibling checkpoints with the PyTorch/CUDA port.

    python3 scripts/soup_search_torch.py NAME=WEIGHT:PATH,WEIGHT:PATH,... ... [--out-dir DIR]

The port's counterpart of ``scripts/soup_search.py``. Each ``NAME=...``
argument defines one soup: the weighted average (weights normalised to sum
to 1) of ``.pv`` model files of one shape, read and written through the
port's ``params_io``. Each soup is saved as ``<out-dir>/<NAME>.pv``,
evaluated on the whole battery of fixture sets with
``scripts/train_model_torch.py``'s ``eval_all`` (on the CPU, as the
reference), and its report saved as ``<out-dir>/report_<NAME>.json``; then
its gaps (``scripts/ledger_from_report.py``'s ``gaps``) are printed against
the ledger ``tests/known_gaps.py``: new ones, ledgered ones, closed ones.
``--out-dir`` defaults to ``resources/ckpts/``, which git ignores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts"), os.path.join(REPO, "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

CKPTS = os.path.join(REPO, "resources", "ckpts")


def _combine(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _combine(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_combine(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def soup(members):
    """[(weight, path)] -> (weighted sum of the files' parameter trees, the
    first file's config). The weights are used as given."""
    from koala_tpu_torch.models import params_io

    acc, cfg0 = None, None
    for w, path in members:
        params, cfg = params_io.load_params(path)
        if acc is None:
            acc = _combine(lambda x: np.asarray(x, np.float32) * np.float32(w), params)
            cfg0 = cfg
        else:
            acc = _combine(lambda a, x: a + np.asarray(x, np.float32) * np.float32(w), acc, params)
    return acc, cfg0


def parse_spec(spec: str):
    """``NAME=W:PATH,W:PATH`` -> (name, [(normalised weight, path)])."""
    name, rest = spec.split("=", 1)
    members = []
    for part in rest.split(","):
        w, path = part.split(":", 1)
        members.append((float(w), path))
    total = sum(w for w, _ in members)
    return name, [(w / total, p) for w, p in members]


def summarize(name, results):
    """Prints the soup's gaps against the ledger; -> (new gaps, all gaps)."""
    from known_gaps import KNOWN_GAPS
    from ledger_from_report import gaps

    fails = gaps(results)
    new = {k: v for k, v in fails.items() if k not in KNOWN_GAPS}
    closed = [k for k in KNOWN_GAPS if k not in fails]
    print("== %s: %d fails (%d new, %d ledger-closed)" % (name, len(fails), len(new), len(closed)))
    for k, v in sorted(fails.items()):
        tag = ("LEDGER %.4f" % KNOWN_GAPS[k]) if k in KNOWN_GAPS else "NEW"
        print("   %-44s %.4f  %s" % (str(k), v, tag))
    for k in closed:
        print("   CLOSED: %s (was %.4f)" % (str(k), KNOWN_GAPS[k]))
    return len(new), len(fails)


def main(argv=None) -> dict:
    """Makes, evaluates and ranks every soup; -> {name: (blob, report path)}."""
    from koala_tpu_torch.models import params_io
    from train_model_torch import eval_all

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("soups", nargs="+", help="NAME=WEIGHT:PATH,WEIGHT:PATH,...")
    ap.add_argument("--out-dir", default=CKPTS)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    written = {}
    for spec in args.soups:
        name, members = parse_spec(spec)
        params, cfg = soup(members)
        blob = os.path.join(args.out_dir, name + ".pv")
        params_io.save_params(blob, params, cfg)
        results = eval_all(params, cfg)
        report = os.path.join(args.out_dir, "report_%s.json" % name)
        with open(report, "w") as fh:
            json.dump(results, fh, indent=1)
        summarize(name, results)
        print("blob -> %s, report -> %s" % (blob, report), flush=True)
        written[name] = (blob, report)
    return written


if __name__ == "__main__":
    main()
