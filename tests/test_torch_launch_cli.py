"""The port's train CLI (``python -m repro_torch.launch.train``) against
the reference's (``python -m repro.launch.train``), and under
``torchrun`` on 4 gloo ranks against its one-process run.

Bounds: the ``done:`` line equal but for its losses, which it prints to 4
decimals: losses within 1e-5 print at most 1e-4 apart, so they are held
within 1e-4 + 1e-5.  The port starts from the reference's initial state,
carried over through a checkpoint the port's CLI resumes from.
"""
from __future__ import annotations

import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import base as ref_base
from repro.models.model_zoo import build_model as ref_build_model
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import base
from repro_torch.models.convert import state_from_numpy

ROOT = os.path.dirname(os.path.dirname(__file__))
TOL = 1e-5


def _done(text: str) -> tuple[str, list[float]]:
    line = [ln for ln in text.splitlines() if ln.startswith("done:")][-1]
    return line, [float(v) for v in
                  re.search(r"loss (\S+) -> (\S+)", line).groups()]


@pytest.mark.slow
def test_train_cli_matches_reference_cli(tmp_path, monkeypatch):
    args = ["--arch", "granite_3_2b", "--reduced", "--steps", "3"]
    # the reference's CLI, in this process
    from repro.launch import train as ref_train

    monkeypatch.setattr(sys, "argv", ["train"] + args)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_train.main()
    want, want_losses = _done(buf.getvalue())

    # the port's CLI from the reference's initial state (the Trainer
    # resumes from the checkpoint of step 0)
    cfg = base.get("granite_3_2b").reduced()
    ref = RefTrainer(ref_build_model(ref_base.get("granite_3_2b").reduced()),
                     RefTrainConfig(steps=3, batch=8, seq=128, lr=1e-3,
                                    warmup=2))
    state = state_from_numpy(cfg, jax.tree.map(np.array, ref.init_state()),
                             device="cpu")
    save_checkpoint(str(tmp_path), 0, state)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "resumed from step 0" in proc.stdout
    got, got_losses = _done(proc.stdout)
    assert got.split(" loss ")[0] == want.split(" loss ")[0]
    # printed to 4 decimals: losses within TOL print at most 1e-4 apart
    np.testing.assert_allclose(got_losses, want_losses, rtol=0,
                               atol=1e-4 + TOL)


@pytest.mark.slow
def test_train_cli_under_torchrun_on_four_ranks():
    """The CLI on a 2x2 mesh of 4 gloo ranks prints the ``done:`` line of
    the one-process run."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--arch", "granite_3_2b",
            "--reduced", "--steps", "2", "--batch", "4", "--seq", "32",
            "--device", "cpu"]
    one = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=600, env=env)
    assert one.returncode == 0, one.stderr[-4000:]
    four = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", *args, "--model-axis", "2"],
        capture_output=True, text=True, timeout=600, env=env)
    assert four.returncode == 0, four.stderr[-4000:]
    assert "mesh: {'data': 2, 'model': 2}" in four.stdout
    (want, want_losses), (got, got_losses) = _done(one.stdout), _done(
        four.stdout)
    assert got.split(" loss ")[0] == want.split(" loss ")[0]
    np.testing.assert_allclose(got_losses, want_losses, rtol=0,
                               atol=1e-4 + TOL)
    assert four.stdout.count("done:") == 1
