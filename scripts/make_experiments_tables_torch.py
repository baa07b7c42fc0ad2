#!/usr/bin/env python
"""Render the dry-run and roofline tables of the PyTorch port's dry-run.

The counterpart of ``scripts/make_experiments_tables.py`` for the port:
it reads ``build/dryrun_results.json``, which ``python -m
repro_torch.launch.dryrun --all`` writes (or several such files, one per
process of a split run, merged), and ``build/hillclimb_results.json``
where there is one, and renders the same two tables:

  * dry-run: one row per cell, arch, shape, mesh, status, seconds, memory
    per rank and whether it fits the card;
  * roofline: one row per ``ok`` cell, the compute, memory and collective
    terms, the bottleneck and the useful-FLOPs ratio (the model's FLOPs
    over the counted ones), with the hill-climbed cell's terms as a note.

With ``--doc FILE`` the tables replace the ``<!-- DRYRUN_TABLE -->`` and
``<!-- ROOFLINE_TABLE -->`` markers of that document in place; without it
they are printed.  The last line counts the ok, skipped and failed cells.

The port's numbers are not XLA's, and the columns keep the reference's
names: "s" is the seconds the port took to run the cell's step on fake
tensors (the reference's is its compile time); the memory comes from the
port's ``memory_per_chip``, where ``arguments`` is what the step finds
resident (parameters, optimizer state, inputs, caches), ``temps`` the
peak less that, and ``peak`` (which decides ``fits``) their sum.  A
record without ``arguments`` or ``temps`` shows "—" there: no split is
made up from ``peak``.

Usage:
  python scripts/make_experiments_tables_torch.py [--results PATH ...]
      [--hillclimb PATH] [--doc FILE]

Imports only the standard library.
"""
from __future__ import annotations

import argparse
import json
import os

RESULTS = os.path.join("build", "dryrun_results.json")
HILLCLIMB = os.path.join("build", "hillclimb_results.json")
SKIP_NOTE = "skipped (long-context needs sub-quadratic attention)"


def fmt_bytes(b) -> str:
    return "—" if b is None else f"{b / 2**30:.1f}"


def dryrun_table(results: dict) -> str:
    lines = [
        "| arch | shape | mesh | status | s | args GiB | temps GiB | fits |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for k in sorted(results):
        v = results[k]
        arch, shape, mesh = k.split("|")[:3]
        if v["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | {mesh} | {SKIP_NOTE} "
                         f"| — | — | — | — |")
            continue
        if v["status"] != "ok":
            lines.append(f"| {arch} | {shape} | {mesh} | {v['status']} "
                         f"| {v.get('seconds', 0):.0f} | — | — | — |")
            continue
        r = v["report"]
        m = r["memory_per_chip"]
        lines.append(
            f"| {arch} | {shape} | {mesh} | {v['status']} "
            f"| {v['seconds']:.0f} | {fmt_bytes(m.get('arguments'))} "
            f"| {fmt_bytes(m.get('temps'))} | {r['fits']} |")
    return "\n".join(lines)


def roofline_table(results: dict, hillclimb: dict | None = None) -> str:
    hillclimb = hillclimb or {}
    lines = [
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "bottleneck | MODEL/HLO flops | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for k in sorted(results):
        v = results[k]
        if v["status"] != "ok":
            continue
        arch, shape, mesh = k.split("|")[:3]
        r = v["report"]
        note = ""
        if k in hillclimb and hillclimb[k].get("status") == "ok":
            h = hillclimb[k]["report"]
            note = (f"**optimized**: {h['compute_term']:.2f}/"
                    f"{h['memory_term']:.2f}/{h['collective_term']:.2f} s, "
                    f"useful {h['useful_flops_ratio']:.2f}, "
                    f"fits {h['fits']}")
        lines.append(
            f"| {arch} | {shape} | {mesh} | {r['compute_term']:.3f} "
            f"| {r['memory_term']:.3f} | {r['collective_term']:.3f} "
            f"| {r['bottleneck']} | {r['useful_flops_ratio']:.2f} "
            f"| {note} |")
    return "\n".join(lines)


def counts(results: dict) -> tuple[int, int, int]:
    """``(ok, skipped, failed)`` cells."""
    ok = sum(1 for v in results.values() if v["status"] == "ok")
    sk = sum(1 for v in results.values() if v["status"] == "skipped")
    return ok, sk, len(results) - ok - sk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", nargs="+", default=[RESULTS],
                    help="results files, merged (a later one wins a cell)")
    ap.add_argument("--hillclimb", default=HILLCLIMB)
    ap.add_argument("--doc", help="document whose markers take the tables")
    args = ap.parse_args(argv)
    results = {}
    for path in args.results:
        with open(path) as f:
            results.update(json.load(f))
    try:
        with open(args.hillclimb) as f:
            hillclimb = json.load(f)
    except FileNotFoundError:
        hillclimb = {}
    dry, roof = dryrun_table(results), roofline_table(results, hillclimb)
    if args.doc:
        with open(args.doc) as f:
            doc = f.read()
        doc = doc.replace("<!-- DRYRUN_TABLE -->", dry)
        doc = doc.replace("<!-- ROOFLINE_TABLE -->", roof)
        with open(args.doc, "w") as f:
            f.write(doc)
    else:
        print(dry, roof, sep="\n\n")
    ok, sk, failed = counts(results)
    print(f"tables {'written' if args.doc else 'printed'}: {ok} ok, "
          f"{sk} skipped, {failed} failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
