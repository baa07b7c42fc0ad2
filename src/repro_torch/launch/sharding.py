"""Sharding plans, PyTorch port of ``repro.launch.sharding``: logical
parameter axes -> per-dimension mesh axes -> DTensor placements, and the
rules for activation constraints.

Strategy (the reference's, arch-universal):

  * Parameter storage is FSDP/ZeRO-3: the "embed"-like dim of every weight
    shards over "data" (and "pod"); expert and vocab/head dims shard over
    "model" (EP / TP) *when divisible* — a per-shape guard drops any axis
    whose dim is not divisible by the mesh axis, so every parameter is
    evenly sharded.
  * Compute parallelism comes from activation constraints (heads / mlp /
    vocab / sequence over "model"), which tolerate uneven dims (DTensor
    shards unevenly, as GSPMD pads).
  * The residual stream is sequence-sharded over "model" between layers
    (Megatron-SP).

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, each None, a mesh axis name or a tuple of names.
:func:`to_placements` turns it into DTensor placements, one per mesh
axis: a dim over ``("data", "pod")`` is ``Shard(d)`` on both axes.  A
dim over two axes is laid out mesh-major in DTensor (``pod`` before
``data`` on a ``("pod", "data", "model")`` mesh) where GSPMD takes the
spec's order; the per-rank shard shapes, all that the plan prices, are
the same.  The tree functions return trees of :class:`Sharding` (the
counterpart of ``NamedSharding``: a mesh, a spec and its placements);
:func:`shard_params` and :func:`shard_tree` apply them with
``distribute_tensor``.  Every function here works on an
:class:`~repro_torch.launch.mesh.AbstractMesh` too, but for those two.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.layers import named_leaves


@dataclasses.dataclass(frozen=True)
class Plan:
    """Maps logical axes to mesh axes.  None = replicate."""

    name: str = "fsdp_tp"
    rules: tuple = (
        ("vocab", "model"),
        ("embed", ("data", "pod")),   # FSDP over data AND pod (multi-pod
                                      # halves per-chip master params;
                                      # guard drops "pod" on 1-pod meshes)
        ("heads", "model"),
        ("kv", "model"),
        ("head_dim", None),
        ("mlp", "model"),
        ("mlp2", None),
        ("expert", "model"),
        ("layers", None),
    )
    # activation constraints (uneven-tolerant)
    act_rules: tuple = (
        ("batch", ("pod", "data")),
        ("heads", "model"),
        ("mlp", "model"),
        ("vocab", "model"),
        ("seq", "model"),
        ("expert", "model"),
    )

    def rule(self, axis):
        return dict(self.rules).get(axis)

    def act_rule_map(self, mesh, *, seq_shard=True):
        m = dict(self.act_rules)
        if not seq_shard:
            m["seq"] = None
        return {k: _filter_axes(v, mesh) for k, v in m.items()}


def _filter_axes(axes, mesh):
    if axes is None:
        return None
    names = mesh.mesh_dim_names
    if isinstance(axes, str):
        return axes if axes in names else None
    kept = tuple(a for a in axes if a in names)
    return kept if kept else None


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def guard_spec(shape, spec, mesh) -> tuple:
    """Drop sharding on any dim not divisible by its mesh-axis product, and
    on repeated mesh axes (first occurrence wins — e.g. MoE expert weights
    map both 'expert' and 'mlp' to the model axis; EP takes priority).
    Every returned spec shards ``shape`` evenly."""
    out = []
    used: set = set()
    for d, axes in enumerate(spec):
        axes = _filter_axes(axes, mesh)
        if axes is None or d >= len(shape):
            out.append(None)
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        ax_tuple = tuple(a for a in ax_tuple if a not in used)
        if not ax_tuple:
            out.append(None)
            continue
        axes = ax_tuple[0] if len(ax_tuple) == 1 else ax_tuple
        size = _axis_size(mesh, axes)
        if shape[d] % size == 0:
            out.append(axes)
            used.update(ax_tuple)
        else:
            out.append(None)
    return tuple(out)


def logical_to_spec(logical: tuple, plan: Plan) -> list:
    """Raw per-dim axis list (duplicates allowed: e.g. MoE expert weights
    before the guard dedups them)."""
    return [plan.rule(a) if a is not None else None for a in logical]


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh axis,
    ``Shard(d)`` for the tensor dim ``d`` that names it (the first, if
    several do), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d in reversed(range(len(spec))):
        axes = _filter_axes(spec[d], mesh)
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout: ``spec`` on ``mesh`` (``NamedSharding``'s
    counterpart)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's shard of a ``shape`` tensor (the spec
        shards it evenly, as :func:`guard_spec` makes sure)."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(n // _axis_size(self.mesh, _filter_axes(a, self.mesh))
                     for n, a in zip(shape, spec))


def _children(struct):
    """The (key, child) pairs of a tree node (a mapping, a list, a
    ``ParamTree`` or ``nn.ModuleList``), or None for a leaf."""
    from torch import nn

    if isinstance(struct, nn.ModuleList):
        return list(enumerate(struct))
    if isinstance(struct, nn.Module):
        return list(struct._parameters.items()) + list(struct._modules.items())
    if isinstance(struct, dict):
        return list(struct.items())
    if isinstance(struct, (list, tuple)):
        return list(enumerate(struct))
    return None


def _rebuild(struct, items):
    from torch import nn

    if isinstance(struct, (list, tuple, nn.ModuleList)):
        return [v for _, v in items]
    return dict(items)


def tree_map_leaves(fn, struct):
    """``fn(leaf)`` over a tree, as nested dicts and lists (a
    ``ParamTree`` maps to a dict, an ``nn.ModuleList`` to a list)."""
    kids = _children(struct)
    if kids is None:
        return fn(struct)
    return _rebuild(struct, [(k, tree_map_leaves(fn, v)) for k, v in kids])


def param_shardings(model, params_struct, mesh, plan: Plan):
    """A :class:`Sharding` tree for the params (fake or concrete)."""
    def walk(struct, spec):
        kids = _children(struct)
        if kids is not None:
            return _rebuild(struct, [
                (k, walk(v, spec[k] if isinstance(spec, (dict, list))
                         else spec)) for k, v in kids])
        logical = spec if isinstance(spec, tuple) else ()
        p = logical_to_spec(logical, plan)
        return Sharding(mesh, guard_spec(struct.shape, p, mesh))

    return walk(params_struct, model.param_specs())


def mirror_opt_shardings(param_sh, opt_struct, mesh):
    """Optimizer state shardings: leaves with the same shape as their param
    inherit the param spec; factored leaves drop an axis (``vr`` the last,
    ``vc`` the second-last); anything else is replicated.  The state is
    the port's optimizers' (``repro_torch.optim``): moments keyed by the
    parameter's ``/``-joined path."""
    flat_p = named_leaves(param_sh)

    def one(keys, leaf):
        core = "/".join(k for k in keys if k not in
                        ("m", "v", "vr", "vc", "opt"))
        sh = flat_p.get(core)
        nd = len(leaf.shape)
        if sh is not None and len(sh.spec) >= nd:
            spec = list(sh.spec)
            if keys and keys[-1] == "vr":      # factored: drop last dim
                spec = spec[:-1]
            elif keys and keys[-1] == "vc":    # factored: drop 2nd-last
                spec = spec[:-2] + spec[-1:]
            spec = (spec + [None] * nd)[:nd]
        else:
            spec = [None] * nd
        return Sharding(mesh, guard_spec(leaf.shape, spec, mesh))

    def walk(tree, keys):
        kids = _children(tree)
        if kids is None:
            return one(keys, tree)
        return _rebuild(tree, [(k, walk(v, keys + (str(k),)))
                               for k, v in kids])

    return walk(opt_struct, ())


def batch_shardings(batch_struct, mesh, batch_axes_: tuple):
    def one(leaf):
        spec = [batch_axes_] + [None] * (len(leaf.shape) - 1)
        return Sharding(mesh, guard_spec(leaf.shape, spec, mesh))
    return tree_map_leaves(one, batch_struct)


def cache_shardings(cache_struct, mesh, batch_axes_: tuple,
                    length_axis: str = "model"):
    """KV caches: batch over DP axes, cache-length dim over `model`
    (flash-decoding style KV parallelism); recurrent states shard their
    widest divisible channel dim over `model`.

    ``cache_struct`` is the port's flat list of per-block caches
    (``Model.init_cache``); the reference's scanned caches carry a
    leading layer-groups axis, which it never shards."""
    length = _axis_size(mesh, length_axis)

    def spec_for(shape):
        spec = [None] * len(shape)
        if len(shape) > 0:
            spec[0] = batch_axes_
        if len(shape) > 1:
            spec[1] = length_axis
        # fallback: if the length dim can't shard (recurrent states),
        # try the widest trailing channel dim
        if len(shape) > 1 and shape[1] % length:
            spec[1] = None
            for d in range(len(shape) - 1, 1, -1):
                if shape[d] % length == 0:
                    spec[d] = length_axis
                    break
        return Sharding(mesh, guard_spec(shape, spec, mesh))

    return tree_map_leaves(lambda leaf: spec_for(tuple(leaf.shape)),
                           cache_struct)


def shard_tree(tree, shardings):
    """A copy of ``tree`` (nested dicts and lists of tensors) with each
    tensor laid out by its :class:`Sharding`: a plain tensor is
    distributed (every rank holds the same global value and keeps its own
    shard: no data moves), a DTensor redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(leaf, sh):
        if isinstance(leaf, DTensor):
            return leaf.redistribute(sh.mesh, sh.placements)
        return distribute_tensor(leaf, sh.mesh, sh.placements,
                                 src_data_rank=None)

    flat_sh = named_leaves(shardings)

    def walk(t, keys):
        kids = _children(t)
        if kids is None:
            return one(t, flat_sh["/".join(keys)])
        return _rebuild(t, [(k, walk(v, keys + (str(k),))) for k, v in kids])

    return walk(tree, ())


def shard_params(model, params, mesh, plan: Plan | None = None):
    """Lay out a ``ParamTree`` by the plan, in place: every parameter
    becomes an ``nn.Parameter`` holding a DTensor with
    :func:`param_shardings`' placements (``requires_grad`` kept); every
    rank holds the same values and keeps its own shard.
    Returns the tree."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    shardings = param_shardings(model, params, mesh, plan or DEFAULT_PLAN)

    def walk(module, sh):
        for name, p in list(module._parameters.items()):
            d = distribute_tensor(p.detach(), mesh, sh[name].placements,
                                  src_data_rank=None)
            module._parameters[name] = nn.Parameter(
                d, requires_grad=p.requires_grad)
        for key, child in module._modules.items():
            walk(child, sh[int(key)] if isinstance(sh, list) else sh[key])

    walk(params, shardings)
    return params


DEFAULT_PLAN = Plan()

# Named plan variants (hypothesis -> change -> measure)
PLAN_VARIANTS: dict[str, Plan] = {
    "baseline": DEFAULT_PLAN,
    # no sequence sharding of the residual stream: shows why SP is load-
    # bearing for memory (scan carries grow 16x)
    "noseq": Plan(name="noseq", act_rules=(
        ("batch", ("pod", "data")), ("heads", "model"), ("mlp", "model"),
        ("vocab", "model"), ("seq", None), ("expert", "model"))),
    # pure FSDP: no tensor parallelism on activations at all
    "fsdp_only": Plan(name="fsdp_only", act_rules=(
        ("batch", ("pod", "data")), ("heads", None), ("mlp", None),
        ("vocab", None), ("seq", "model"), ("expert", "model"))),
    # TP on params too (vocab/heads/mlp dims over model where divisible)
    # is already the baseline param rule set; this variant turns OFF fsdp
    # (params replicated over data) to measure the FSDP all-gather cost
    "no_fsdp": Plan(name="no_fsdp", rules=(
        ("vocab", "model"), ("embed", None), ("heads", "model"),
        ("kv", "model"), ("head_dim", None), ("mlp", "model"),
        ("mlp2", None), ("expert", "model"), ("layers", None))),
}
