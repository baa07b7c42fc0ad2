#!/usr/bin/env python
"""Conformance audit of the PyTorch port: keep its CPU suite honest.

Static checks (no test execution), checks 3 and 4 of
``scripts/audit_slow_markers.py`` carried over to the port's suite,
``tests/test_torch_conformance.py``; ``scripts/ci_torch.sh`` runs it
before pytest:

  3. the suite caps its hypothesis profile for CI (the ``ci`` profile
     exists, is the env-var default and caps ``max_examples`` at <= 50)
     and keeps a ``nightly`` profile for the scheduled deep-fuzz job;
  4. the suite's pinned floor stays >= 200 random specs
     (``N_BLOCKS * BLOCK``).

Exits non-zero with a message on any violation.  Imports only the
standard library.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SUITE = ROOT / "tests" / "test_torch_conformance.py"


def fail(msg: str) -> None:
    print(f"port conformance audit: FAIL: {msg}")
    sys.exit(1)


def main() -> None:
    conf = SUITE.read_text()
    # 3. hypothesis profiles: ci-capped, nightly available
    # (whitespace-insensitive so a reformat cannot trip the audit)
    for pattern, why in [
        (r'register_profile\(\s*"ci"', "the capped CI profile"),
        (r'register_profile\(\s*"nightly"', "the nightly profile"),
        (r'os\.environ\.get\(\s*"HYPOTHESIS_PROFILE",\s*"ci"\s*\)',
         "the env-selected default profile"),
    ]:
        if not re.search(pattern, conf):
            fail(f"{SUITE.name} lost {why}")
    m = re.search(r'"ci",\s*max_examples=(\d+)', conf)
    if not m or int(m.group(1)) > 50:
        fail(f"the 'ci' hypothesis profile of {SUITE.name} must cap "
             "max_examples at <= 50 (tier-1 wall-clock)")

    # 4. the pinned floor stays >= 200 specs
    m = re.search(r"N_BLOCKS, BLOCK = (\d+), (\d+)", conf)
    if not m or int(m.group(1)) * int(m.group(2)) < 200:
        fail(f"the seed-pinned floor of {SUITE.name} dropped below 200 "
             "random specs (N_BLOCKS * BLOCK)")

    print("port conformance audit: OK (hypothesis ci profile capped, "
          "nightly profile kept; conformance floor >= 200)")


if __name__ == "__main__":
    main()
