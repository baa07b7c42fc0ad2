"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
every configuration at a small grid, run on the port's plain versions."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TINY_SHAPES = {2: (40, 36), 3: (12, 10, 9)}


def copy_bench(dest: Path) -> Path:
    """``BENCHMARK.json`` and this folder, as a checkout holds them."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(Path(__file__).parent, dest / "stencilbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def shrink(root: Path) -> None:
    """Every configuration file of ``root``'s benchmark at a small grid."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for c in doc["configs"]:
        path = root / c["file"]
        text = path.read_text()
        m = re.search(r"^SHAPE = \(([^)]*)\)$", text, re.M)
        ndim = len([x for x in m.group(1).split(",") if x.strip()])
        path.write_text(text.replace(
            m.group(0), f"SHAPE = {TINY_SHAPES[ndim]!r}"))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = copy_bench(tmp_path / "checkout")
    shrink(root)
    return root


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one torch thread: the plain versions at small grids
    gain nothing from more, and threads that spin beside other test
    workers slow a run a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
