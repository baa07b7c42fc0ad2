"""The port's mesh path of training: the sharded ``Trainer`` on a 2x2
("data", "model") mesh of 4 CPU ranks over gloo against the unsharded one
(``tests/_torch_mesh_main.py trainer``, a subprocess).

Bounds: the first step's gradients within ``GRAD_TOL`` (lm_train's gate
(a) float32 ``grad_max_rel``) of the unsharded port ``Trainer``'s (itself
held to the reference by ``tests/test_torch_trainer.py``), leaf by leaf,
each leaf's largest difference over the tree's largest |grad| and over
the leaf's own.  This is the check that sees a wrong gradient scale (a
gradient summed twice over a replicated mesh axis): AdamW's m/sqrt(v)
does not change when a leaf's gradient is scaled by a constant, so the
losses and parameters below cannot.  3 sharded steps' losses and every
parameter after them within 1e-5 of the unsharded Trainer, and a sharded
run that crashes after its step-2 checkpoint and resumes (every rank
reading the directory right after rank 0 wrote it, with no barrier of
the test's own) bitwise equal to the straight sharded run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen2_moe_a2_7b"])
def test_sharded_trainer_matches_unsharded(arch, tmp_path):
    out = tmp_path / "out.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_mesh_main.py"), "trainer",
         arch, str(out)], capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(out.read_text())
    assert len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], got["ref_losses"], rtol=0,
                               atol=TOL)
    assert got["param_max_abs_err"] <= TOL, got["param_max_abs_err"]
    assert got["grad_keys_equal"]
    assert got["grad_max_rel"] <= GRAD_TOL, got["grad_max_rel"]
    worst = max(got["grad_leaf_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] <= GRAD_TOL, worst
    assert got["resume_bitwise"], (got["resumed_losses"], got["losses"])
    # the parameters are laid out by the plan: FSDP over data, TP/EP over
    # model where the dims divide
    pl = got["placements"]
    assert pl["layers.0.attn.wq"] == ["S(0)", "S(1)"]
    if arch == "qwen2_moe_a2_7b":
        assert got["ep_calls"] > 0                 # the EP branch ran
        assert pl["layers.0.moe.wi"] == ["S(1)", "S(0)"]
