"""The model's mesh context: where a layer's code meets DTensor.

``set_mesh_rules(mesh, rules)`` installs a ``DeviceMesh`` and the map
from logical activation axes to mesh axes (re-exported by
``models.transformer``, where the reference keeps it); ``constrain``
then redistributes a DTensor activation to the placements the rules give
(``repro_torch.launch.sharding.to_placements``) at the reference's cut
points.  The model runs SPMD on DTensor parameters and inputs under
``implicit_replication`` (plain tensors made inside the model count as
replicated), so DTensor's sharding propagation and collectives stand
where GSPMD's do.

Every helper here is the identity, or the plain op, without a mesh or on
a tensor that is not a DTensor, so the layers call them unconditionally
and no other module of the model tests for DTensor.  They do what GSPMD
does and DTensor cannot:

  * :func:`per_rank` runs a function on each rank's local shards (a
    ``local_map``), as GSPMD partitions an op DTensor has no rule for
    (attention, the embedding lookup, a dispatch that is not
    expert-parallel);
  * :func:`even_split` gathers a dim before a view that would split it
    unevenly (8 or 32 heads over 16 ranks), where GSPMD pads;
    :func:`project` is a head projection that goes through it, forward
    and backward, and :func:`rows_by_table` a product that merges no
    sharded dim;
  * :func:`grad_as_param` brings a parameter's gradient back in the
    parameter's layout, so a tied table's two gradients add;
  * ``constrain`` and ``per_rank`` keep a dim whole where its mesh axes
    do not divide it (a batch of 1 over 16 ranks);
  * :func:`sum_grad` and :func:`psum` are the autograd-aware collectives
    of ``shard_map``'s transposes, for code that runs on local shards.
"""
from __future__ import annotations

import math
from typing import Any

import torch

_MESH_CTX: dict[str, Any] = {"mesh": None, "rules": {}}


def set_mesh_rules(mesh, rules: dict):
    """rules: logical activation axis -> mesh axis (or tuple), e.g.
    {"batch": ("pod", "data"), "heads": "model", "mlp": "model",
     "vocab": "model", "embed": None}."""
    _MESH_CTX["mesh"] = mesh
    _MESH_CTX["rules"] = dict(rules)


def clear_mesh_rules():
    _MESH_CTX["mesh"] = None
    _MESH_CTX["rules"] = {}


def mesh():
    """The installed ``DeviceMesh``, or None."""
    return _MESH_CTX["mesh"]


def rule(axis: str):
    """The mesh axes the installed rules give a logical axis, or None."""
    return _MESH_CTX["rules"].get(axis)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _placements(shape, logical, m):
    from repro_torch.launch.sharding import guard_spec, to_placements

    spec = guard_spec(shape, tuple(rule(a) for a in logical), m)
    return to_placements(spec, m)


def constrain(x, logical: tuple):
    """``x`` redistributed to the placements of ``logical`` under the
    installed rules; the identity without a mesh or for a tensor that is
    not a DTensor.  A dim its mesh axes do not divide stays whole (the
    plan's ``guard_spec``): GSPMD pads an uneven dim, and DTensor's uneven
    shards break ops (a batch of 1 over 16 ranks)."""
    m = mesh()
    if m is None or not _is_dtensor(x):
        return x
    return x.redistribute(m, _placements(x.shape, logical, m))


def replicated(t, logical: tuple):
    """A tensor made inside the model, on a mesh laid out by ``logical``
    (a replicated DTensor constrained); without one, ``t``."""
    m = mesh()
    if m is None:
        return t
    from torch.distributed.tensor import Replicate, distribute_tensor

    t = distribute_tensor(t, m, [Replicate()] * m.ndim, src_data_rank=None)
    return constrain(t, logical)


def even_split(t, dim: int, lead: int):
    """``t`` ready for a view that splits dim ``dim`` into (``lead``, ...):
    a DTensor sharded on ``dim`` over mesh axes whose product does not
    divide ``lead`` is gathered along those axes first (DTensor cannot
    split an unevenly sharded dim, where GSPMD pads); anything else is
    returned as it is."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    dim %= t.ndim
    m, pl = t.device_mesh, list(t.placements)
    on = [i for i, q in enumerate(pl) if isinstance(q, Shard) and q.dim == dim]
    if lead % math.prod(m.size(i) for i in on) == 0:
        return t
    for i in on:
        pl[i] = Replicate()
    return t.redistribute(m, pl)


class _MergeHeads(torch.autograd.Function):
    """w (D,H,K) viewed as (D,H*K); the gradient's split back into heads
    goes through :func:`even_split`."""

    @staticmethod
    def forward(ctx, w):
        ctx.heads = w.shape[1:]
        return w.reshape(w.shape[0], -1)

    @staticmethod
    def backward(ctx, g):
        return even_split(g, -1, ctx.heads[0]).reshape(g.shape[0],
                                                       *ctx.heads)


def project(x, w):
    """x (B,S,D) @ w (D,H,K) -> (B,S,H,K): the product over the merged
    (H*K) columns, then the split into heads."""
    H, K = w.shape[1:]
    y = torch.einsum("bsd,de->bse", x, _MergeHeads.apply(w))
    return even_split(y, -1, H).reshape(*y.shape[:-1], H, K)


def rows_by_table(h, table):
    """h (B,S,D) times table (V,D) transposed: (B,S,V).  A DTensor ``h``
    takes a product batched over B, which merges no dim (its B and S may
    both be sharded, and DTensor cannot merge a dim sharded behind
    another); a plain one takes one product over the merged (B*S) rows."""
    if _is_dtensor(h):
        return torch.bmm(h, table.t().expand(h.shape[0], -1, -1))
    return torch.einsum("bsd,vd->bsv", h, table)


class _GradAsParam(torch.autograd.Function):
    """Identity forward; the gradient comes back in the parameter's own
    layout, so the gradients of two uses of one parameter (a tied
    embedding's lookup and unembedding) add in one layout."""

    @staticmethod
    def forward(ctx, w):
        ctx.layout = (w.device_mesh, w.placements)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


def grad_as_param(w):
    """``w``, its gradient laid out as ``w`` (a DTensor), else ``w``."""
    return _GradAsParam.apply(w) if _is_dtensor(w) else w


def _all_reduce(x, group):
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum",
                                                group))


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = _all_reduce(g, group)
        return g, None


def sum_grad(x, groups):
    """Identity forward; backward sums the gradient over ``groups`` (a
    local input replicated over those mesh axes whose uses differ by
    rank)."""
    return _SumGrad.apply(x, groups)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x, group):
    """``lax.psum`` over ``group``: an all-reduce forward; the gradient of
    the (replicated) sum passes to each rank's addend unchanged."""
    return _Psum.apply(x, group)


def per_rank(fn, args, logical, out_logical, sum_grad_over=None):
    """``fn`` on each rank's local shards, as the reference's GSPMD runs an
    op it partitions: under the installed mesh, ``local_map`` lays each
    tensor argument out by its logical axes (a plain tensor counts as
    replicated), runs ``fn`` on the local tensors and returns a DTensor
    laid out by ``out_logical``.  ``sum_grad_over`` maps an argument's
    index to a logical axis: the argument is whole on the ranks of that
    axis's mesh axes and used there on different data, so its gradient
    is summed over them.  Without a mesh, or without a DTensor argument,
    ``fn(*args)``."""
    m = mesh()
    if m is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.sharding import guard_spec, to_placements

    # a logical axis some argument's dim does not divide over its mesh
    # axes stays whole everywhere (local_map assumes even shards)
    whole = {name for a, lg in zip(args, logical)
             for name, kept in zip(lg, guard_spec(
                 a.shape, tuple(rule(n) for n in lg), m))
             if rule(name) is not None and kept is None}

    def placements(axes):
        return list(to_placements(tuple(
            None if a in whole else rule(a) for a in axes), m))

    def groups(axis):
        axes = rule(axis)
        return [m.get_group(a) for a in
                ((axes,) if isinstance(axes, str) else axes or ())]

    sums = {i: groups(axis) for i, axis in (sum_grad_over or {}).items()}

    def local(*xs):
        return fn(*[sum_grad(x, sums[i]) if sums.get(i) else x
                    for i, x in enumerate(xs)])

    args = [a if _is_dtensor(a) else distribute_tensor(
        a, m, [Replicate()] * m.ndim, src_data_rank=None) for a in args]
    return local_map(local, out_placements=placements(out_logical),
                     in_placements=tuple(placements(lg) for lg in logical),
                     redistribute_inputs=True, device_mesh=m)(*args)
