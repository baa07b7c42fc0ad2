"""Roofline terms of a PyTorch step, priced for the NVIDIA H100 SXM; port
of ``repro.roofline.analysis``.

  compute term    = FLOPs / (chips * peak FLOP/s)
  memory term     = bytes / (chips * HBM bytes/s)
  collective term = collective bytes per chip / link bytes/s

The reference reads these from a compiled XLA program: FLOPs and bytes
from the partitioned HLO text, trip-count aware, collective bytes from
its all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute operands.  A PyTorch step is no HLO module, so the
text parser (``analyze_hlo``, ``collective_bytes_from_hlo``,
``parse_hlo_module``) has no counterpart: :func:`analyze_step` runs the
step itself under :class:`OpCounter`, a dispatch mode that sees every
aten op one rank executes:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    registry: products, convolutions, attention), as the reference counts
    dots and convolutions;
  * bytes as operand plus output bytes of every op that materialises a
    tensor (views are free), the reference's rule for unfused ops;
  * collective bytes as the operand bytes of every functional collective
    the step issues, by kind, with their counts.

Counts are per rank, as the reference's partitioned module is per device:
on a DTensor step the mode lets DTensor lower each op to its local ops
and collectives and counts those; the global-shape ops DTensor runs only
to propagate shapes (``ShardingPropagator._propagate_tensor_meta_non_cached``,
under the fake mode of a fake step, see :func:`in_sharding_propagation`;
a torch without that private method is refused) are not counted.  So the whole-job
FLOPs and bytes are the per-rank counts times ``chips``, the reference's
rule.  Layers run as a Python loop and remat recomputes in the backward
pass, so every layer and every recompute is counted as it runs: the count
is trip-aware by construction.

Hardware constants (NVIDIA's H100 SXM data sheet, dense, at the 700 W
power limit): 989e12 FLOP/s bf16, 3.35e12 B/s HBM, 450e9 B/s NVLink each
way.  A report's HBM limit is the card's own
(``torch.cuda.get_device_properties(0).total_memory``) or, on a host
without a card, an argument.
"""
from __future__ import annotations

import dataclasses
import sys
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

H100_PEAK_BF16 = 989e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 450e9
H100_HBM_BYTES = 80e9         # the data sheet's 80 GB, for a host without a card

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL_NAMESPACES = ("_c10d_functional", "c10d_functional",
                      "_c10d_functional_autograd")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree):
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _shapes(args) -> str:
    return " ".join("x".join(map(str, t.shape)) for t in _tensors(args))


def _is_view(func) -> bool:
    """An op whose outputs alias an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


_PROPAGATION_FN = "_propagate_tensor_meta_non_cached"


def check_propagation_hook():
    """Raises unless the running torch's ``ShardingPropagator`` has the
    method :func:`in_sharding_propagation` looks for on the stack (a
    private one): without it the skip would silently stop, and a rank's
    counts and memory would take in the global-shape ops."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if not callable(getattr(ShardingPropagator, _PROPAGATION_FN, None)):
        raise RuntimeError(
            f"torch {torch.__version__}: ShardingPropagator has no "
            f"{_PROPAGATION_FN}; the per-rank counts cannot tell DTensor's "
            "shape propagation from the rank's own ops")


def in_sharding_propagation() -> bool:
    """Whether the caller runs inside DTensor's shape propagation, which
    runs an op on global-shape fake tensors (under the active fake mode,
    when there is one) before the rank's local op runs."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == _PROPAGATION_FN:
            return True
        f = f.f_back
    return False


class OpCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes and collectives while active (see
    the module docstring).  ``ops`` tallies op calls by name."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collective_counts = {k: 0 for k in COLLECTIVES}
        self.ops: Counter = Counter()
        # FLOPs and collective bytes by op and operand shapes, for the dump
        self.by_shape: Counter = Counter()
        self._fake_on_entry = None

    def __enter__(self):
        from torch._guards import active_fake_mode

        check_propagation_hook()
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # count DTensor's local ops
        out = func(*args, **kwargs)
        if active_fake_mode() is self._fake_on_entry \
                and not in_sharding_propagation():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        name = func._overloadpacket.__name__
        ns = func.namespace
        self.ops[f"{ns}.{name}"] += 1
        if ns in _FUNCOL_NAMESPACES:
            kind = _FUNCOL_KIND.get(name)
            if kind is not None:
                nbytes = sum(_nbytes(t) for t in _tensors(args[:1]))
                self.collective_counts[kind] += 1
                self.collectives[kind] += nbytes
                self.by_shape[f"{kind} {_shapes(args[:1])}"] += nbytes
            return
        if func._overloadpacket in flop_registry:
            flops = flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
            self.flops += flops
            self.by_shape[f"{ns}.{name} {_shapes(args)}"] += flops
        if not _is_view(func):
            self.bytes_accessed += sum(map(_nbytes, _tensors((args, kwargs)))) \
                + sum(map(_nbytes, _tensors(out)))

    def report(self) -> dict:
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "collectives": coll,
                "collective_counts": dict(self.collective_counts)}


def analyze_step(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter`: one rank's
    ``flops``, ``bytes_accessed``, ``collectives`` (bytes by kind and
    ``total``) and ``collective_counts``, the keys of the reference's
    ``analyze_hlo``; ``out`` is ``fn``'s result."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return dict(counter.report(), out=out)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                # whole-job FLOPs (per-rank count * chips)
    hlo_bytes: float
    collective_bytes_per_chip: float
    collective_detail: dict
    compute_term: float
    memory_term: float
    collective_term: float
    model_flops: float              # 6*N*D (active params) per step
    memory_per_chip: dict
    fits: bool

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_term, "memory": self.memory_term,
                 "collective": self.collective_term}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """How close the dominant term is to being the *only* cost: the
        achievable fraction of the compute roofline if perfectly
        overlapped = compute_term / max(all terms)."""
        worst = max(self.compute_term, self.memory_term,
                    self.collective_term)
        return self.compute_term / worst if worst else 0.0

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["bottleneck"] = self.bottleneck
        d["useful_flops_ratio"] = self.useful_flops_ratio
        d["roofline_fraction"] = self.roofline_fraction
        return d


def card_hbm_bytes(hbm_limit: float | None = None) -> float:
    """``hbm_limit`` if given, else the card's memory; raises on a host
    without a card when no limit is given."""
    if hbm_limit is not None:
        return float(hbm_limit)
    if not torch.cuda.is_available():
        raise ValueError("no CUDA card: pass the HBM limit")
    return float(torch.cuda.get_device_properties(0).total_memory)


def roofline_from_step(counts: dict, *, arch: str, shape: str,
                       mesh_desc: str, chips: int, model_flops: float,
                       memory_per_chip: dict,
                       hbm_limit: float | None = None) -> RooflineReport:
    """The report of one step from :func:`analyze_step`'s per-rank
    ``counts`` and its per-rank memory (``memory_per_chip["peak"]``,
    bytes, decides ``fits``)."""
    flops_total = counts["flops"] * chips
    bytes_total = counts["bytes_accessed"] * chips
    coll = dict(counts["collectives"])
    coll["counts"] = counts["collective_counts"]
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        hlo_flops=flops_total, hlo_bytes=bytes_total,
        collective_bytes_per_chip=float(coll["total"]),
        collective_detail=coll,
        compute_term=flops_total / (chips * H100_PEAK_BF16),
        memory_term=bytes_total / (chips * H100_HBM_BW),
        collective_term=coll["total"] / H100_NVLINK_BW,
        model_flops=model_flops,
        memory_per_chip=dict(memory_per_chip),
        fits=memory_per_chip["peak"] <= card_hbm_bytes(hbm_limit),
    )
