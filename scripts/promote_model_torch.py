"""Promote a trained candidate to the bundled model, with the PyTorch/CUDA port's gates.

    python3 scripts/promote_model_torch.py CANDIDATE.pv REPORT.json [--models-dir DIR]

The port's counterpart of ``scripts/promote_model.py``. It refuses (exit 1)
unless every acceptance gate passes: ``scripts/train_model_torch.py``'s
``check_gates`` with ``allow_known_gaps=True``, so a candidate may keep the
gaps that ``tests/known_gaps.py`` records but may not be worse than them. On
success, in ``--models-dir`` (default ``models/``):

- copies the blob to ``koala_params_tpu.pv``;
- writes ``train_report.json`` (the candidate's evaluation report);
- removes stale experiment blobs (``koala_params_tpu_r*.pv``) and their
  reports (``train_report_r*.json``).

A candidate that closes ledger entries prints "KNOWN-GAP (allowed)" lines
only for those it still has: bring ``tests/known_gaps.py`` up to date after
promoting (``scripts/ledger_from_report.py REPORT.json`` prints the entries).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)


def main(argv=None) -> int:
    from train_model_torch import check_gates

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("candidate")
    ap.add_argument("report")
    ap.add_argument("--models-dir", default=os.path.join(REPO, "models"))
    args = ap.parse_args(argv)
    with open(args.report) as fh:
        results = json.load(fh)
    if not check_gates(results, allow_known_gaps=True):
        print("refusing to promote: gates failed (new regression or worse-than-ledger gap)")
        return 1
    dst = os.path.join(args.models_dir, "koala_params_tpu.pv")
    shutil.copyfile(args.candidate, dst)
    with open(os.path.join(args.models_dir, "train_report.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    for pattern in ("koala_params_tpu_r*.pv", "train_report_r*.json"):
        for stale in glob.glob(os.path.join(args.models_dir, pattern)):
            os.remove(stale)
            print("removed stale", stale)
    print("promoted", args.candidate, "->", dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
