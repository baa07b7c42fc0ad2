"""``python -m repro_torch.store`` -- inspect and maintain a persistent
design store (:mod:`repro_torch.runtime.store`).

Subcommands (all take the store root as their first argument)::

    python -m repro_torch.store list   <root>   # entries of the current env
    python -m repro_torch.store verify <root>   # decode all; quarantine corrupt
    python -m repro_torch.store prune  <root>   # drop stale envs + quarantine

``list`` prints one line per entry (type, status, size, torch/CUDA
provenance) plus the environments present; ``verify`` exits non-zero
when any entry had to be quarantined on this pass and, under
``--strict``, also when the quarantine directory holds a backlog from
earlier runs (so CI catches store corruption that a previous replica
already moved aside); ``prune`` deletes every environment directory
except the current one (a torch or CUDA upgrade leaves the old env's
entries unreachable -- this reclaims them) and empties the current
environment's quarantine.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.runtime.store import DesignStore


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.store",
        description="Inspect/maintain a persistent design store.",
    )
    parser.add_argument("command", choices=("list", "verify", "prune"))
    parser.add_argument("root", help="store root directory")
    parser.add_argument(
        "--strict", action="store_true",
        help="verify: also fail on a pre-existing quarantine backlog",
    )
    args = parser.parse_args(argv)

    store = DesignStore(args.root, readonly=(args.command == "list"))
    if args.command == "list":
        envs = store.environments()
        print(f"store root: {store.root}")
        print(f"environments: {', '.join(envs) or '(none)'}")
        print(f"current env: {store.env_tag}")
        entries = store.entries()
        for e in entries:
            if e["status"] == "ok":
                kind = f" kind={e['kind']}" if e.get("kind") else ""
                print(
                    f"  [{e['type']}] {e['file']} ok {e['bytes']}B"
                    f"{kind} torch={e['torch']} cuda={e['cuda']}"
                )
            else:
                print(f"  [{e['type']}] {e['file']} {e['status']}")
        print(f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'}")
        return 0
    if args.command == "verify":
        report = store.verify()
        print(
            f"verify: {report['ok']} ok, "
            f"{report['quarantined']} newly quarantined, "
            f"{report['backlog']} in quarantine backlog"
        )
        if report["quarantined"]:
            return 1
        if args.strict and report["backlog"]:
            print("strict: quarantine backlog present (prune to clear)")
            return 1
        return 0
    removed = store.prune()
    print(f"pruned: {', '.join(removed) or '(nothing)'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
