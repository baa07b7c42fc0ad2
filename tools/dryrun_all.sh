#!/usr/bin/env bash
# The port's dry-run over every cell, split over processes, then its tables.
#
# `python -m repro_torch.launch.dryrun --all` runs the 80 cells (10 configs
# x 4 shapes x 2 meshes) one after another in one process; this runs one
# process per (config, shape) pair (both meshes), JOBS at once, deepest
# configs and training cells first, each writing OUT_DIR/<arch>.<shape>.json
# and .log, then renders both tables from all of them with
# scripts/make_experiments_tables_torch.py (its last line counts the ok,
# skipped and failed cells).  No card is used (CUDA_VISIBLE_DEVICES is
# emptied): the cells run on fake tensors on the CPU.
#
# Usage: tools/dryrun_all.sh OUT_DIR [JOBS]   (JOBS defaults to nproc)
set -euo pipefail
cd "$(dirname "$0")/.."
out=${1:?usage: tools/dryrun_all.sh OUT_DIR [JOBS]}
jobs=${2:-$(nproc)}
mkdir -p "$out"
export PYTHONPATH=src CUDA_VISIBLE_DEVICES=
python - <<'EOF' |
from repro_torch.configs import base
from repro_torch.launch.dryrun import SHAPES

archs = sorted(base.all_archs(), key=lambda a: -base.get(a).n_layers)
for shape in SHAPES:
    for arch in archs:
        print(arch, shape)
EOF
  xargs -P "$jobs" -L 1 sh -c 'python -m repro_torch.launch.dryrun --all \
      --arch "$1" --shape "$2" --results "$0/$1.$2.json" > "$0/$1.$2.log" \
      2>&1 || echo "dryrun $1 $2 exited $?"' "$out"
python scripts/make_experiments_tables_torch.py --results "$out"/*.json
