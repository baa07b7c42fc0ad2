"""Assigned-architecture roofline table from the port's dry-run -- the
counterpart of ``benchmarks/lm_roofline.py``.

Reads ``build/dryrun_results.json`` (written by ``python -m
repro_torch.launch.dryrun --all``; ``$DRYRUN_RESULTS`` names another
file) and emits one row per (arch x shape x mesh) cell: the three
roofline terms priced at the H100's numbers, the dominant one, the useful
FLOPs ratio and whether a rank fits the card.  Without the file it emits
a pointer row instead of failing, as the reference does."""
from __future__ import annotations

import json
import os

from repro_torch.launch.dryrun import RESULTS_PATH


def run(device=None):
    del device          # reads a file written by the dry-run
    results_path = os.environ.get("DRYRUN_RESULTS", RESULTS_PATH)
    rows = []
    if not os.path.exists(results_path):
        rows.append(
            "roofline/missing,0.00,"
            "run 'PYTHONPATH=src python -m repro_torch.launch.dryrun --all' "
            "first")
        return rows
    with open(results_path) as f:
        results = json.load(f)
    for key in sorted(results):
        res = results[key]
        arch, shape, mesh = key.split("|")
        if res["status"] == "skipped":
            rows.append(f"roofline/{arch}/{shape}/{mesh},0.00,"
                        f"status=skipped;reason={res['reason'][:60]}")
            continue
        if res["status"] != "ok":
            rows.append(f"roofline/{arch}/{shape}/{mesh},0.00,"
                        f"status=FAILED;reason={res['reason'][:80]}")
            continue
        r = res["report"]
        rows.append(
            f"roofline/{arch}/{shape}/{mesh},"
            f"{max(r['compute_term'], r['memory_term'], r['collective_term'])*1e6:.1f},"
            f"compute_s={r['compute_term']:.4f};"
            f"memory_s={r['memory_term']:.4f};"
            f"collective_s={r['collective_term']:.4f};"
            f"bottleneck={r['bottleneck']};"
            f"useful_flops={r['useful_flops_ratio']:.2f};"
            f"fits={r['fits']}")
    return rows
