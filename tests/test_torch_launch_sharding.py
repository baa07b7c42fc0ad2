"""The port's logical specs and sharding plan (``repro_torch.launch``)
against the reference's, exact, with no devices; and the dry-run's
shape table against the reference's.

The reference's stack is scanned: a leaf of block kind ``pattern[j]``
is stacked on a leading ``"layers"`` axis, which every plan maps to no
mesh axis, and the remainder runs as an unscanned tail.  The port's
stack is a flat list of blocks, so each of its leaves is compared with
the reference's leaf of the same layer, the stacked axis dropped.  The
reference's plan runs on ``jax.sharding.AbstractMesh`` at the production
shapes, the port's on ``repro_torch.launch.mesh.AbstractMesh``.
"""
from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as ref_base
from repro.launch import sharding as ref_sh
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer

from repro_torch.configs import base
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import make_optimizer

ARCHS = base.all_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DECODE = (128, 32768)     # the decode_32k cell's batch and cache length


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn) for v in tree]
    return fn(tree)


def _unstack(cfg, tree, leaf=lambda x: x):
    """A reference tree ({"layers": {"scanned", "tail"}, ...}) in the
    port's layout: one entry per layer, ``leaf`` applied to every leaf,
    a scanned leaf's entry for the stacked axis dropped (``drop``)."""
    def stack(part, pattern, n):
        glen = len(pattern)
        groups = n // glen
        return [_walk(part["scanned"][j], lambda x: leaf(x)[1:])
                if g < groups else _walk(part["tail"][j], leaf)
                for g, j in (divmod(i, glen) for i in range(n))]

    out = {}
    for k, v in tree.items():
        if k == "layers":
            out[k] = stack(v, cfg.pattern, cfg.n_layers)
        elif k == "encoder":
            out[k] = stack(v, cfg.enc_pattern, cfg.enc_layers)
        elif isinstance(v, dict) and "layers" in v:   # optimizer moments
            out[k] = _unstack(cfg, v, leaf)
        else:
            out[k] = _walk(v, leaf)
    return out


def _spec(x):
    """A reference spec (a PartitionSpec or a logical tuple) as a tuple."""
    return tuple(x)


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.fixture(scope="module")
def ref_structs():
    """The reference's abstract params of every config (eval_shape)."""
    return {a: jax.eval_shape(ref_build_model(ref_base.get(a)).init,
                              jax.random.PRNGKey(0)) for a in ARCHS}


@pytest.fixture(scope="module")
def fake_params():
    """The port's params of every config as fake tensors (no storage)."""
    with FakeTensorMode():
        return {a: build_model(base.get(a), device="cpu").init(
            torch.Generator()) for a in ARCHS}


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_named(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    cfg = base.get(arch)
    want = _unstack(cfg, ref_build_model(ref_base.get(arch)).param_specs())
    want = _walk(want, tuple)
    got = build_model(cfg, device="cpu").param_specs()
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, mesh_name, ref_structs,
                                         fake_params):
    """Every leaf's guarded spec, under every plan variant, and the
    per-rank parameter bytes."""
    shape, names = MESHES[mesh_name]
    ref_mesh, mesh = RefAbstractMesh(shape, names), AbstractMesh(shape, names)
    cfg = base.get(arch)
    ref_model, model = ref_build_model(ref_base.get(arch)), build_model(
        cfg, device="cpu")
    params = fake_params[arch]
    for plan_name, ref_plan in ref_sh.PLAN_VARIANTS.items():
        ref_shs = ref_sh.param_shardings(ref_model, ref_structs[arch],
                                         ref_mesh, ref_plan)
        want_bytes = sum(
            math.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
            for s, l in zip(jax.tree.leaves(ref_shs),
                            jax.tree.leaves(ref_structs[arch])))
        want = _named(_unstack(cfg, jax.tree.map(
            lambda s: s.spec, ref_shs,
            is_leaf=lambda s: hasattr(s, "spec")), _spec))
        got_sh = sh.param_shardings(model, params, mesh,
                                    sh.PLAN_VARIANTS[plan_name])
        got = {k: s.spec for k, s in _named(got_sh).items()}
        assert set(got) == set(want), plan_name
        for k, spec in got.items():
            assert _pad(spec, 4) == _pad(want[k], 4), (plan_name, k)
        leaves = {k.replace(".", "/"): p for k, p in
                  params.named_parameters()}
        got_bytes = sum(math.prod(s.shard_shape(leaves[k].shape))
                        * leaves[k].element_size()
                        for k, s in _named(got_sh).items())
        assert got_bytes == want_bytes, plan_name


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen2_moe_a2_7b",
                                  "recurrentgemma_2b", "mamba2_130m",
                                  "llama4_maverick_400b_a17b"])
def test_mirror_opt_shardings_match_reference(arch, optimizer, ref_structs,
                                              fake_params):
    shape, names = MESHES["2x16x16"]
    ref_mesh, mesh = RefAbstractMesh(shape, names), AbstractMesh(shape, names)
    cfg = base.get(arch)
    ref_model = ref_build_model(ref_base.get(arch))
    ref_psh = ref_sh.param_shardings(ref_model, ref_structs[arch], ref_mesh,
                                     ref_sh.DEFAULT_PLAN)
    ref_opt = jax.eval_shape(ref_make_optimizer(optimizer).init,
                             ref_structs[arch])
    ref_osh = ref_sh.mirror_opt_shardings(ref_psh, ref_opt, ref_mesh)
    want = _named(_unstack(cfg, jax.tree.map(
        lambda s: s.spec, ref_osh, is_leaf=lambda s: hasattr(s, "spec")),
        _spec))

    params = fake_params[arch]
    model = build_model(cfg, device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        opt = make_optimizer(optimizer).init(params)
    got_sh = sh.mirror_opt_shardings(
        sh.param_shardings(model, params, mesh, sh.DEFAULT_PLAN), opt, mesh)
    got = {}
    for k, s in _named(got_sh).items():
        # the port keys moments by parameter path: m/<path>, v/<path>/vr
        kind, rest = k.split("/", 1)
        got[f"{kind}/{rest}"] = s.spec
    assert set(got) == set(want)
    for k, spec in got.items():
        assert _pad(spec, 4) == _pad(want[k], 4), k


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    ref_mesh, mesh = RefAbstractMesh(shape, names), AbstractMesh(shape, names)
    cfg = base.get(arch)
    batch, length = DECODE
    ba = tuple(a for a in ("pod", "data") if a in names)
    ref_cache = jax.eval_shape(
        lambda: ref_build_model(ref_base.get(arch)).init_cache(batch, length))
    ref_csh = ref_sh.cache_shardings(ref_cache, ref_mesh, ba)
    sc, tails = jax.tree.map(lambda s: s.spec, ref_csh,
                             is_leaf=lambda s: hasattr(s, "spec"))
    want = _unstack(cfg, {"layers": {"scanned": sc or [], "tail": tails}},
                    _spec)["layers"]
    with FakeTensorMode():
        caches = build_model(cfg, device="cpu").init_cache(batch, length)
    got = sh.cache_shardings(caches, mesh, ba)
    assert len(got) == len(want) == cfg.n_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        for k in g:
            assert _pad(g[k].spec, 5) == _pad(w[k], 5), (i, k)


def test_batch_shardings_match_reference():
    shape, names = MESHES["2x16x16"]
    ref_mesh, mesh = RefAbstractMesh(shape, names), AbstractMesh(shape, names)
    structs = {"tokens": (256, 4096), "labels": (256, 4096),
               "odd": (7, 3), "frontend_embeds": (256, 1024, 1024)}
    ref = ref_sh.batch_shardings(
        {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in structs.items()},
        ref_mesh, ("pod", "data"))
    got = sh.batch_shardings({k: torch.empty(s, device="meta")
                              for k, s in structs.items()}, mesh,
                             ("pod", "data"))
    for k in structs:
        assert _pad(got[k].spec, 3) == _pad(tuple(ref[k].spec), 3), k


def test_guard_spec_and_plan_rules():
    """The reference's ``test_dryrun_machinery.py::
    test_guard_spec_and_plan_rules``, on the port (no devices needed)."""
    mesh = AbstractMesh((1, 1), ("data", "model"))
    # duplicate axes are deduped, first occurrence wins
    assert sh.guard_spec((8, 16, 32), ("model", "data", "model"), mesh) == \
        ("model", "data", None)
    # axis size 1 divides everything
    assert sh.guard_spec((7,), ("model",), mesh) == ("model",)
    # non-divisible dims fall back to replication
    assert sh.guard_spec((7, 32), ("model", "data"),
                         AbstractMesh((4, 4), ("data", "model"))) == \
        (None, "data")

    plan = sh.DEFAULT_PLAN
    assert plan.rule("expert") == "model"
    # embed carries FSDP over data AND pod (guard drops "pod" when absent)
    assert sh.logical_to_spec(("expert", "embed", "mlp"), plan) == \
        ["model", ("data", "pod"), "model"]


def test_placements_of_a_spec():
    """A dim over two axes is ``Shard`` on both; unnamed axes replicate;
    the first dim naming an axis takes it."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.to_placements(("model", ("data", "pod"), None), mesh) == (
        Shard(1), Shard(1), Shard(0))
    assert sh.to_placements((None, None), mesh) == (Replicate(),) * 3
    assert sh.to_placements(("model", "model"), mesh) == (
        Replicate(), Replicate(), Shard(0))
    assert sh.Sharding(mesh, ("model", ("data", "pod"))).shard_shape(
        (64, 64, 5)) == (4, 2, 5)


# ---------------------------------------------------------------------------
# the dry-run's shape table (b)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun`` imported after JAX's backend is up (its
    import sets XLA_FLAGS, read only when the backend first starts), with
    the environment put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_table_matches_reference(arch, ref_dryrun):
    from repro_torch.launch import dryrun

    assert dryrun.SHAPES == ref_dryrun.SHAPES
    cfg, ref_cfg = base.get(arch), ref_base.get(arch)
    for shape in dryrun.SHAPES:
        assert dryrun.applicable(cfg, shape) == \
            ref_dryrun.applicable(ref_cfg, shape)
        assert dryrun.model_flops_estimate(cfg, shape) == \
            ref_dryrun.model_flops_estimate(ref_cfg, shape)


def test_input_specs_match_reference(ref_dryrun):
    """The cell's model inputs: shapes and guarded specs."""
    from repro_torch.launch import dryrun

    shape, names = MESHES["2x16x16"]
    ref_mesh, mesh = RefAbstractMesh(shape, names), AbstractMesh(shape, names)
    for arch in ("internvl2_1b", "granite_3_2b"):
        for cell in dryrun.SHAPES:
            want_s, want_sh = ref_dryrun.input_specs(ref_base.get(arch), cell,
                                                     ref_mesh)
            got_s, got_sh = dryrun.input_specs(base.get(arch), cell, mesh)
            assert set(got_s) == set(want_s)
            for k in got_s:
                assert got_s[k][0] == tuple(want_s[k].shape)
                assert np.dtype(str(got_s[k][1]).split(".")[1]) == \
                    want_s[k].dtype
                assert _pad(got_sh[k].spec, 3) == \
                    _pad(tuple(want_sh[k].spec), 3), (arch, cell, k)


def test_batch_specs_shape_dtype_spec():
    from repro_torch.data.pipeline import make_batch_specs

    cfg = base.get("internvl2_1b")
    specs = make_batch_specs(cfg, 8, 64, batch_axes=("data",))
    assert specs["tokens"] == ((8, 64), torch.int32, (("data",), None))
    assert specs["frontend_embeds"][0] == (8, cfg.n_frontend_tokens or 16,
                                           cfg.frontend_dim)
    assert specs["frontend_embeds"][2] == (("data",), None, None)
    assert P(("data",), None) == P(*specs["labels"][2])
