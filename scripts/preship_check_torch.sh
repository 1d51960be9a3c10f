#!/usr/bin/env bash
# Pre-ship gate of the PyTorch/CUDA port (the counterpart of
# scripts/preship_check.sh). Runs, in order, the port's tests, bench_torch.py
# and the bundled model's acceptance gates (scripts/train_model_torch.py
# --eval-only --gate --allow-known-gaps --cpu); writes their outputs to
# resources/reports/preship_torch/ and exits nonzero if any step fails.
#
#   bash scripts/preship_check_torch.sh
#
# The port's tests hold it against the JAX package, so the machine needs jax
# beside a CUDA card (bench_torch.py runs on the card). KOALA_PRESHIP_OUT:
# where the outputs go (default resources/reports/preship_torch).
set -u
cd "$(dirname "$0")/.."
out=${KOALA_PRESHIP_OUT:-resources/reports/preship_torch}
mkdir -p "$out"
fail=0

echo "== pytest =="
python -m pytest tests/test_torch_*.py -q -p no:cacheprovider 2>&1 \
    | tail -2 | tee "$out/pytest.txt"
grep -qE "[0-9]+ passed" "$out/pytest.txt" || fail=1
# real failures only ("N failed" / "N error(s)"), not "N xfailed"
grep -qE "[0-9]+ (failed|error)" "$out/pytest.txt" && fail=1

echo "== bench =="
if python3 bench_torch.py > "$out/bench.json" 2> "$out/bench.err"; then
    tail -1 "$out/bench.json"
else
    echo "bench_torch.py FAILED"; tail -5 "$out/bench.err"; fail=1
fi

echo "== model gate =="
if python3 scripts/train_model_torch.py --eval-only --gate --allow-known-gaps --cpu \
        > "$out/gate.txt" 2>&1; then
    tail -1 "$out/gate.txt"
else
    echo "MODEL GATE FAILED"; grep "GATE FAIL" "$out/gate.txt" | head -10; fail=1
fi

if [ "$fail" -eq 0 ]; then
    echo "PRESHIP: ALL GREEN"
else
    echo "PRESHIP: RED - do not ship"
fi
exit $fail
