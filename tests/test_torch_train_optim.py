"""The port's optimizers (``repro_torch.optim``) against the JAX reference's
on the same gradient sequence, and the reference's own optimizer tests
(``tests/test_train_substrate.py``) ported.

Tolerance: parameters and moments within ``TOL`` (absolute and relative)
of the reference's after every step.  Both sides round every operation
to float32 in the same order; they differ only where a float32 scalar
(a bias correction, the schedule's cosine) or a division rounds in the
last bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine_schedule

from repro_torch.optim import adafactor, adamw, cosine_schedule, make_optimizer

TOL = 1e-6


def _tree(seed):
    """Parameters of several shapes: a matrix big enough to be factored,
    one that is not, a vector and a 3-D stack."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((160, 130)).astype(np.float32),
            "small": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "stack": {"x": rng.standard_normal((2, 128, 129)).astype(
                np.float32)}}


def _grads(tree, step):
    rng = np.random.default_rng(100 + step)
    # scaled so that the clip engages on some steps and not on others
    scale = 0.002 if step % 2 else 1.0
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape))
                        .astype(np.float32), tree)


def _as_torch(tree):
    return jax.tree.map(torch.tensor, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def _run_both(ref_opt, opt, steps=6):
    ref_params = jax.tree.map(jnp.asarray, _tree(0))
    ref_state = ref_opt.init(ref_params)
    params = _as_torch(_tree(0))
    state = opt.init(params)
    for step in range(steps):
        g = _grads(_tree(0), step)
        ref_params, ref_state = ref_opt.update(
            jax.tree.map(jnp.asarray, g), ref_state, ref_params,
            jnp.asarray(step, jnp.int32))
        params, state = opt.update(_as_torch(g), state, params, step)
        _close(_flat(jax.tree.map(lambda t: t.numpy(), params)),
               _flat(ref_params))
    return ref_state, state


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_matches_reference(compress):
    lr = ref_cosine_schedule(3e-2, 2, 10)
    ref_state, state = _run_both(
        ref_adamw(lr, compress_grads=compress),
        adamw(cosine_schedule(3e-2, 2, 10), compress_grads=compress))
    for moment in ("m", "v"):
        got = {k: v.numpy() for k, v in state[moment].items()}
        want = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
                for path, v in
                jax.tree_util.tree_flatten_with_path(ref_state[moment])[0]}
        _close(got, want)


def test_adafactor_matches_reference():
    ref_state, state = _run_both(
        ref_adafactor(ref_cosine_schedule(5e-2, 2, 10), weight_decay=0.01),
        adafactor(cosine_schedule(5e-2, 2, 10), weight_decay=0.01))
    assert set(state["v"]["w"]) == {"vr", "vc"}
    assert set(state["v"]["small"]) == {"v"}
    assert set(state["v"]["stack/x"]) == {"vr", "vc"}
    assert state["v"]["stack/x"]["vr"].shape == (2, 128)
    for k, leaf in (("w", ref_state["v"]["w"]),
                    ("small", ref_state["v"]["small"]),
                    ("stack/x", ref_state["v"]["stack"]["x"])):
        _close({n: t.numpy() for n, t in state["v"][k].items()},
               {n: np.asarray(a) for n, a in leaf.items()})


def test_schedule_matches_reference():
    ref, got = ref_cosine_schedule(3e-4, 7, 50), cosine_schedule(3e-4, 7, 50)
    for step in range(0, 56):
        assert got(step) == pytest.approx(float(ref(step)), rel=TOL, abs=1e-12)


def test_update_is_in_place_and_without_gradient():
    opt = make_optimizer("adamw", lr=1e-2, total_steps=10, warmup=0)
    w = torch.nn.Parameter(torch.ones(4))
    state = opt.init({"w": w})
    params, state2 = opt.update({"w": torch.ones(4)}, state, {"w": w}, 1)
    assert params["w"] is w and state2 is state
    assert not torch.equal(w.detach(), torch.ones(4))
    assert not torch.equal(state["m"]["w"], torch.zeros(4))
    with pytest.raises(ValueError):
        make_optimizer("sgd")


def test_missing_gradient_is_zero():
    """A parameter the loss never used (``autograd.grad`` gives None) is
    updated as with a zero gradient, as the reference's is."""
    opt = adamw(1e-2)
    p0, p1 = {"w": torch.ones(3)}, {"w": torch.ones(3)}
    s0, s1 = opt.init(p0), opt.init(p1)
    opt.update({"w": None}, s0, p0, 3)
    opt.update({"w": torch.zeros(3)}, s1, p1, 3)
    assert torch.equal(p0["w"], p1["w"])


# --- tests/test_train_substrate.py's optimizer tests, on the port ---------


def test_adamw_converges_quadratic():
    opt = adamw(1e-1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for step in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = opt.update(grads, state, params, step)
    assert float(params["w"].abs().max()) < 1e-2


def test_adafactor_converges_matrix():
    opt = adafactor(5e-2, weight_decay=0.0, min_dim_factored=4)
    params = {"w": torch.ones((8, 8)) * 2.0}
    state = opt.init(params)
    for step in range(300):
        grads = {"w": 2 * params["w"]}
        params, state = opt.update(grads, state, params, step)
    assert float(params["w"].abs().max()) < 5e-2
    # factored state really is factored (vectors, not a matrix)
    v = state["v"]["w"]
    assert set(v) == {"vr", "vc"} and v["vr"].shape == (8,)


def test_schedule_warmup_and_decay():
    lr = cosine_schedule(1.0, warmup=10, total=100)
    assert lr(0) == 0.0
    assert lr(10) == pytest.approx(1.0)
    assert lr(100) == pytest.approx(0.0, abs=1e-6)
    assert lr(5) == pytest.approx(0.5)
