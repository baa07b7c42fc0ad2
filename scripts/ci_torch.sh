#!/usr/bin/env bash
# CI gate of the PyTorch/CUDA port (src/repro_torch) on the CPU: lint, the
# stencil lint gate, the conformance audit, the dry-run tables on a small
# cell, the port's tests, a smoke run of its quickstart and the benchmark
# smoke gates (benchmarks_torch/).
# The counterpart of scripts/ci.sh, which gates the JAX package.
#
# Usage: scripts/ci_torch.sh [fast]
#   fast: skip the `slow`-marked subprocess tests.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

MARK=()
if [[ "${1:-}" == "fast" ]]; then
  MARK=(-m "not slow")
fi

PORT_FILES=(src/repro_torch examples_torch benchmarks_torch
            scripts/lint_stencils_torch.py scripts/audit_slow_markers_torch.py
            scripts/make_experiments_tables_torch.py tests/test_torch_*.py
            tests/_torch_*.py)

echo "== lint: pyflakes (the port) =="
# hosts without pyflakes fall back to a byte-compile pass, as scripts/ci.sh
if python -c "import pyflakes" >/dev/null 2>&1; then
  python -m pyflakes "${PORT_FILES[@]}"
else
  echo "pyflakes not installed; falling back to compileall"
  python -m compileall -q "${PORT_FILES[@]}"
fi

echo "== lint: stock kernels + example DSL (the port's analyzer) =="
# every stock kernel x 4 boundary modes and every DSL source under
# examples_torch/ must verify with zero error-severity diagnostics
python scripts/lint_stencils_torch.py

echo "== lint: machine-readable numerics pass over examples_torch =="
# python -m repro_torch.lint's JSON mode over every DSL literal embedded
# in examples_torch/, with the JSON document's shape checked
python -m repro_torch.lint --format json --from-py examples_torch/*.py | python -c '
import json, sys
doc = json.load(sys.stdin)
assert doc["version"] == 1 and "summary" in doc, "bad lint JSON shape"
s = doc["summary"]
print("lint JSON ok: %d literal(s), %d error(s), %d warning(s)"
      % (len(doc["files"]), s["errors"], s["warnings"]))
'

echo "== audit: the port's conformance suite (profiles, pinned floor) =="
python scripts/audit_slow_markers_torch.py

echo "== tables: make_experiments_tables_torch.py on a small dry-run =="
# one 1-layer cell lowered on the fake backend and one skipped cell, into a
# temporary directory; the script renders both tables from them
TABLES_TMP="$(mktemp -d)"
trap 'rm -rf "$TABLES_TMP"' EXIT
for cell in "mamba2_130m decode_32k --override n_layers=1" \
            "granite_3_2b long_500k"; do
  set -- $cell
  python -m repro_torch.launch.dryrun --arch "$1" --shape "$2" "${@:3}" \
    --results "$TABLES_TMP/dryrun_results.json" > "$TABLES_TMP/dryrun.log"
done
python scripts/make_experiments_tables_torch.py \
  --results "$TABLES_TMP/dryrun_results.json" | tee "$TABLES_TMP/tables.md"
grep -q "tables printed: 1 ok, 1 skipped, 0 failed" "$TABLES_TMP/tables.md"

echo "== tier-1: pytest (the port's tests) =="
python -m pytest -x -q --durations=15 "${MARK[@]}" tests/test_torch_*.py

echo "== smoke: examples_torch/quickstart.py =="
python examples_torch/quickstart.py --device cpu

echo "== smoke: benchmark gates (benchmarks_torch, --smoke --device cpu) =="
# every gate asserted: serving (IR, K2 vs K1, single and mixed geometry,
# mixed boundary, cold start), the model's rank accuracy, open-loop latency.
# All three run; a miss in one fails the script after the last.
failed=()
for script in serving_throughput model_accuracy serving_latency; do
  PYTHONPATH="src:." python "benchmarks_torch/$script.py" --smoke --device cpu --check \
    || failed+=("$script")
done
if (( ${#failed[@]} )); then
  echo "CI FAILED: benchmark gates missed in: ${failed[*]}"
  exit 1
fi

echo "CI OK"
