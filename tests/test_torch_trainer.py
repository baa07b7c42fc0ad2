"""The port's ``Trainer`` (``repro_torch.train``) against the JAX
reference's, and the reference's own trainer tests
(``tests/test_train_substrate.py``) ported.

Parity: both trainers start from the reference's initial state, carried
over by ``state_from_numpy``, and run 8 steps (batch 2, seq 16, lr 3e-3,
warmup 2) on the same synthetic batches; every step's loss agrees within
``LOSS_ABS``.  llama4-maverick is left out: its router's true gradient is
0 and both sides read rounding noise there, which Adafactor's
normalisation turns into updates of about +-lr (``u = g/sqrt(v)``), so
its parameters part within a few steps whatever the port does.
"""
from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore_checkpoint
from repro.configs import base as ref_base
from repro.models.model_zoo import build_model as ref_build_model
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer

from repro_torch.checkpoint import latest_step
from repro_torch.configs import base
from repro_torch.models.convert import state_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.train import TrainConfig, Trainer

LOSS_ABS = 1e-5
PARITY = dict(batch=2, seq=16, lr=3e-3, warmup=2, log_every=100)


def _host(tree):
    """A reference state as numpy copies (its train step donates buffers)."""
    return jax.tree.map(np.array, tree)


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen2_moe_a2_7b",
                                  "mamba2_130m", "recurrentgemma_2b"])
def test_trainer_matches_reference(arch):
    cfg, ref_cfg = base.get(arch).reduced(), ref_base.get(arch).reduced()
    ref = RefTrainer(ref_build_model(ref_cfg), RefTrainConfig(steps=8, **PARITY))
    ref_state = ref.init_state()
    state = state_from_numpy(cfg, _host(ref_state), device="cpu")
    _, want = ref.run(ref_state)
    _, got = Trainer(build_model(cfg, device="cpu"),
                     TrainConfig(steps=8, **PARITY)).run(state)
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ABS)


def test_resume_from_reference_checkpoint(tmp_path):
    """5 reference steps write a checkpoint; the port restores it through
    ``state_from_numpy`` and runs 5 more; its losses are those of 10
    straight reference steps."""
    arch = "internlm2_1_8b"
    cfg, ref_cfg = base.get(arch).reduced(), ref_base.get(arch).reduced()
    ref_model = ref_build_model(ref_cfg)
    _, straight = RefTrainer(ref_model, RefTrainConfig(steps=10, **PARITY)).run()
    writer = RefTrainer(ref_model, RefTrainConfig(
        steps=10, ckpt_dir=str(tmp_path), ckpt_every=5, **PARITY))
    writer.run(steps=5)
    assert latest_step(str(tmp_path)) == 5
    ref_state = ref_restore_checkpoint(str(tmp_path), 5, writer.init_state())
    state = state_from_numpy(cfg, _host(ref_state), device="cpu")
    assert int(state["step"]) == 5
    _, got = Trainer(build_model(cfg, device="cpu"),
                     TrainConfig(steps=10, **PARITY)).run(state)
    np.testing.assert_allclose(got, straight[5:], rtol=0, atol=LOSS_ABS)


def test_state_from_numpy_carries_adafactor_state():
    """Adafactor's per-parameter ``{vr, vc}`` / ``{v}`` state, unstacked
    as the parameters are (llama4-maverick trains with Adafactor)."""
    arch = "llama4_maverick_400b_a17b"
    cfg, ref_cfg = base.get(arch).reduced(), ref_base.get(arch).reduced()
    assert cfg.optimizer == "adafactor"
    ref = RefTrainer(ref_build_model(ref_cfg), RefTrainConfig(steps=1, **PARITY))
    ref_state, _ = ref.run()
    state = state_from_numpy(cfg, _host(ref_state), device="cpu")
    tr = Trainer(build_model(cfg, device="cpu"), TrainConfig(steps=1, **PARITY))
    fresh = tr.init_state()
    assert state["opt"].keys() == fresh["opt"].keys() == {"v"}
    for path, leaf in fresh["opt"]["v"].items():
        got = state["opt"]["v"][path]
        assert got.keys() == leaf.keys(), path
        for n in leaf:
            assert got[n].shape == leaf[n].shape, (path, n)
    assert int(state["step"]) == 1
    assert any(float(v.abs().max()) > 0
               for leaf in state["opt"]["v"].values() for v in leaf.values())


# --- tests/test_train_substrate.py's trainer tests, on the port ----------


def tiny_model():
    return build_model(base.get("internlm2_1_8b").reduced(), device="cpu")


def test_crash_resume_is_lossless(tmp_path):
    """5 steps, injected crash, resume, 5 more == 10 straight steps."""
    model = tiny_model()

    straight = Trainer(model, TrainConfig(
        steps=10, batch=2, seq=16, ckpt_dir=None, log_every=100))
    state_a, losses_a = straight.run()

    crashy = Trainer(model, TrainConfig(
        steps=10, batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=5,
        log_every=100, fail_at_step=5))
    with pytest.raises(RuntimeError, match="injected failure"):
        crashy.run()
    assert latest_step(str(tmp_path)) == 5

    resumed = Trainer(model, TrainConfig(
        steps=10, batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=5,
        log_every=100))
    state_b, losses_b = resumed.run()

    for a, b in zip(state_a["params"].parameters(),
                    state_b["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(losses_a[5:], losses_b, rtol=1e-6)


def test_training_reduces_loss():
    model = tiny_model()
    tr = Trainer(model, TrainConfig(steps=30, batch=4, seq=32, lr=3e-3,
                                    warmup=5, log_every=100))
    _, losses = tr.run()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_straggler_detector_fires():
    model = tiny_model()
    events = []
    tr = Trainer(model, TrainConfig(steps=25, batch=2, seq=16, log_every=100,
                                    straggler_zscore=3.0),
                 on_straggler=lambda **kw: events.append(kw))
    orig = tr.train_step

    calls = {"n": 0}

    def slow_step(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 24:
            time.sleep(1.0)
        return orig(*a, **kw)

    tr.train_step = slow_step
    tr.run()
    assert events and events[0]["zscore"] > 3.0


def test_trainer_defaults_to_the_models_device():
    tr = Trainer(tiny_model(), TrainConfig(steps=1, batch=1, seq=4))
    assert tr.data.device == torch.device("cpu")
    state = tr.init_state()
    assert all(p.requires_grad and p.device.type == "cpu"
               for p in state["params"].parameters())
    assert int(state["step"]) == 0
