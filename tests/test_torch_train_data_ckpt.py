"""The port's data pipeline and checkpoints (``repro_torch.data``,
``repro_torch.checkpoint``) against the JAX reference's, and the
reference's own tests of them (``tests/test_train_substrate.py``) ported.

Tokens and labels are bitwise the reference's; frontend embeddings (the
same numpy draw on both sides) within 1e-7.  A checkpoint round trip is
bitwise, for every dtype the state can hold (bfloat16 through its bits).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMData as RefSyntheticLMData

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.data import SyntheticLMData
from repro_torch.models import layers as L


@pytest.mark.parametrize("vocab,frontend", [(100, 0), (49155, 0), (256, 8)])
@pytest.mark.parametrize("seed", [0, 3])
def test_batches_match_reference(vocab, frontend, seed):
    kw = dict(vocab=vocab, batch=3, seq=17, seed=seed,
              frontend_tokens=frontend, frontend_dim=12 if frontend else 0)
    ref = RefSyntheticLMData(**kw)
    got = SyntheticLMData(device="cpu", **kw)
    for step in (0, 1, 7, 1000):
        want, have = ref.batch_at(step), got.batch_at(step)
        assert set(have) == set(want)
        for k in ("tokens", "labels"):
            assert have[k].dtype == torch.int32
            np.testing.assert_array_equal(have[k].numpy(), np.asarray(want[k]))
        if frontend:
            np.testing.assert_allclose(have["frontend_embeds"].numpy(),
                                       np.asarray(want["frontend_embeds"]),
                                       rtol=0, atol=1e-7)


def test_data_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLMData(vocab=10, batch=1, seq=4)


def test_data_pipeline_deterministic_and_stateless():
    """``tests/test_train_substrate.py``'s data test, on the port."""
    d1 = SyntheticLMData(vocab=100, batch=4, seq=16, seed=3, device="cpu")
    d2 = SyntheticLMData(vocab=100, batch=4, seq=16, seed=3, device="cpu")
    b1, b2 = d1.batch_at(7), d2.batch_at(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = d1.batch_at(8)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    toks = b1["tokens"]
    assert toks.min() >= 0 and toks.max() < 100
    assert torch.equal(next(iter(d1))["tokens"], d1.batch_at(0)["tokens"])


def _tree():
    return {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.tensor(7, dtype=torch.int32),
                  "d": [torch.ones(4), torch.zeros(2)]},
            "h": torch.randn(5, generator=torch.Generator().manual_seed(0))
            .bfloat16()}


def _zeros_like(tree):
    return {k: torch.zeros_like(v) for k, v in L.named_leaves(tree).items()}


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    """``tests/test_train_substrate.py``'s round trip on the port, with a
    bfloat16 leaf: restored bitwise, in place, dtype kept."""
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 5, tree)
    assert os.path.basename(path) == "step_00000005"
    assert latest_step(str(tmp_path)) == 5
    like = _zeros_like(tree)
    restored = restore_checkpoint(str(tmp_path), 5, like)
    assert restored is like
    for k, v in L.named_leaves(tree).items():
        assert restored[k].dtype == v.dtype
        assert torch.equal(restored[k], v), k
    # no .tmp directories may survive a successful commit
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json")
                          .read_text())
    leaves = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    assert set(leaves) == {"a", "b/c", "b/d/0", "b/d/1", "h"}
    assert leaves["h"]["dtype"] == "bfloat16"
    assert leaves["b/d/0"]["file"] == "b_d_0.npy"


def test_checkpoint_paths_of_a_param_tree(tmp_path):
    """A ``ParamTree`` inside the state is stored under its ``/``-joined
    parameter paths, and restored into a fresh tree in place."""
    params = L.ParamTree({"embed": torch.ones(3, 2),
                          "layers": [{"attn": {"wq": torch.full((2, 2), 2.)}}]})
    state = {"params": params, "step": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 3, state)
    names = sorted(os.listdir(tmp_path / "step_00000003"))
    assert names == ["manifest.json", "params_embed.npy",
                     "params_layers_0_attn_wq.npy", "step.npy"]
    fresh = {"params": L.ParamTree({
        "embed": torch.zeros(3, 2),
        "layers": [{"attn": {"wq": torch.zeros(2, 2)}}]}),
        "step": torch.tensor(0, dtype=torch.int32)}
    restore_checkpoint(str(tmp_path), 3, fresh)
    assert int(fresh["step"]) == 3
    assert torch.equal(fresh["params"]["layers"][0]["attn"]["wq"],
                       torch.full((2, 2), 2.))


def test_restore_refuses_another_shape_or_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="w: stored"):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="w: stored"):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3).double()})


def test_async_checkpointer_keeps_last_k_and_snapshots(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.zeros(4)
    for step in (1, 2, 3, 4):
        w.fill_(step)
        ck.save(step, {"w": w})
        w.fill_(-1.0)           # changed while the writer may still run
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    like = {"w": torch.zeros(4)}
    restore_checkpoint(str(tmp_path), 4, like)
    assert torch.equal(like["w"], torch.full((4,), 4.0))


def test_async_checkpointer_surfaces_writer_error(tmp_path):
    """A failed write is raised by the next ``wait()``, once."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker), keep=2)
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                   # the error was surfaced and cleared
    assert latest_step(str(tmp_path / "absent")) is None
