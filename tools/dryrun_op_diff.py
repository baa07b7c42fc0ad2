"""Diff one dry-run cell's per-operator tallies between two source trees;
prints one JSON line per tree (per-rank FLOPs, collective bytes, peak
memory) and one with the products and collectives whose tallies differ.

The dry-run (``repro_torch.launch.dryrun``) counts one rank's work on
torch's ``fake`` backend; where DTensor lays an op out differently (two
commits, or two torch versions), the tallies by operand shape show which
products moved.  Unpack the other commit with ``git archive <commit> |
tar -x -C build/parent`` (``build/`` is gitignored), then::

    python3 tools/dryrun_op_diff.py build/parent/src src \\
        [--arch granite_3_2b] [--shape train_4k] [--multi-pod] \\
        [--layers N] [--out DIR]

Each tree runs in a process of its own with no card in view
(``CUDA_VISIBLE_DEVICES=``), the two at once; its op dump is written
under ``--out`` (default ``build/op_diff``).
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys

import torch

CELL = r"""
import json, sys
from repro_torch.launch import dryrun
arch, shape, multi_pod, layers, out = sys.argv[1:6]
res = dryrun.lower_cell(
    arch, shape, multi_pod=multi_pod == "1", verbose=False,
    cfg_overrides={"n_layers": int(layers)} if int(layers) else None,
    dump_dir=out)
print("CELL " + json.dumps(dict(status=res.status, reason=res.reason,
                                seconds=res.seconds, op_dump=res.op_dump,
                                report=res.report)))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs=2, help="two src directories: A B")
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this depth (0: full)")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=os.path.join("build", "op_diff"))
    args = ap.parse_args(argv)

    procs = []
    for i, tree in enumerate(args.trees):
        out = os.path.join(args.out, f"tree{i}")
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree),
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CELL, args.arch, args.shape,
             "1" if args.multi_pod else "0", str(args.layers), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    tallies = []
    for tree, proc in zip(args.trees, procs):
        out, err = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("CELL ")]
        if proc.returncode or not lines:
            print(json.dumps(dict(tree=tree, status="failed",
                                  stderr=err[-3000:])))
            return 1
        cell = json.loads(lines[-1][5:])
        if cell["status"] != "ok":
            print(json.dumps(dict(tree=tree, **cell)))
            return 1
        with gzip.open(cell["op_dump"], "rt") as f:
            dump = json.load(f)
        rep = cell["report"]
        print(json.dumps(dict(
            tree=tree, arch=args.arch, shape=args.shape,
            mesh=rep["mesh"], layers=args.layers or "full",
            torch=torch.__version__, flops_per_rank=dump["flops"],
            collective_bytes_per_rank=rep["collective_bytes_per_chip"],
            peak_bytes_per_rank=rep["memory_per_chip"]["peak"],
            seconds=cell["seconds"])), flush=True)
        tallies.append(dump["flops_or_bytes_by_shape"])
    a, b = tallies
    diff = {k: (a.get(k, 0), b.get(k, 0)) for k in set(a) | set(b)
            if a.get(k, 0) != b.get(k, 0)}
    top = sorted(diff.items(), key=lambda kv: -abs(kv[1][0] - kv[1][1]))
    print(json.dumps(dict(diff_by_shape={k: v for k, v in top[:args.top]},
                          differing=len(diff))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
