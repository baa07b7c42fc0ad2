"""Multi-pod dry-run, PyTorch port of ``repro.launch.dryrun``: run one
step of every (architecture x input-shape x mesh) cell at production
size on no hardware; record per-rank memory, FLOPs, bytes and the
collective schedule for the roofline table.

The reference lowers and compiles each cell for 256 or 512 forced XLA
host devices.  Here the step runs for real, on nothing:

  * the default process group is torch's ``fake`` backend with the
    cell's world size (256 for 16x16, 512 for 2x16x16) in this one
    process, so a ``DeviceMesh`` of that shape exists and its collectives
    are no-ops; ``lower_cell`` and ``main`` set it up (and tear down what
    they made), never an import of this module;
  * the parameters, optimizer state, inputs and caches are fake tensors
    (``FakeTensorMode``: shapes and dtypes, no storage), laid out by the
    sharding plan as DTensors, so every op runs DTensor's sharding
    propagation and lowers to one rank's local ops and collectives;
  * the step is the reference's: a train step is ``Model.loss`` and its
    gradients (a Python loop over ``cfg.microbatches``, fp32 gradients
    summed) and the optimizer's update; a serving cell (parameters cast
    to bf16, as the reference's are) runs ``Model.prefill`` or one
    ``Model.decode_step`` against a cache of the cell's length;
  * ``roofline.OpCounter`` counts that rank's FLOPs, bytes and collectives
    and ``MemTracker`` its memory (peak and by kind) while it runs.

A cell is ``ok`` with a :class:`~repro_torch.roofline.RooflineReport`
priced at the H100's numbers (``fits`` against the card's memory, or
the H100's 80 GB on a host without one), ``skipped`` where the reference
skips it, or ``failed`` with its reason.  ``_dump_ops`` writes the
per-operator tally of the step, gzipped, where the reference writes its
HLO text.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_8b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # every cell
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import re
import time
import traceback

import torch

from repro_torch.configs import base as config_base
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import make_optimizer
from repro_torch.roofline import OpCounter, roofline_from_step
from repro_torch.roofline.analysis import H100_HBM_BYTES

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

RESULTS_PATH = os.path.join("build", "dryrun_results.json")


def applicable(cfg, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k decode KV would be "
                       "quadratic-prefill-gated; skipped per docs/DESIGN.md "
                       "§Arch-applicability")
    return True, ""


def input_specs(cfg, shape_name: str, mesh):
    """(shape, dtype) and :class:`~repro_torch.launch.sharding.Sharding`
    of every model input of the cell."""
    seq, gbatch, kind = SHAPES[shape_name]
    ba = batch_axes(mesh)
    if kind == "decode":   # one new token against a seq-length cache
        structs = {"tokens": ((gbatch, 1), torch.int32),
                   "pos": ((gbatch,), torch.int32)}
        specs = {"tokens": (ba, None), "pos": (ba,)}
    else:
        full = make_batch_specs(cfg, gbatch, seq, batch_axes=ba)
        keep = [k for k in full if kind == "train" or k != "labels"]
        structs = {k: full[k][:2] for k in keep}
        specs = {k: full[k][2] for k in keep}
    shardings = {k: shlib.Sharding(mesh, shlib.guard_spec(
        structs[k][0], specs[k], mesh)) for k in structs}
    return structs, shardings


def model_flops_estimate(cfg, shape_name: str) -> float:
    """MODEL_FLOPS = 6*N_active*D tokens (train) or 2*N*D (inference)."""
    seq, gbatch, kind = SHAPES[shape_name]
    n = cfg.params_active_estimate
    if kind == "train":
        return 6.0 * n * seq * gbatch
    if kind == "prefill":
        return 2.0 * n * seq * gbatch
    return 2.0 * n * 1 * gbatch


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str                  # ok | skipped | failed
    reason: str = ""
    seconds: float = 0.0
    report: dict | None = None
    op_dump: str = ""            # gzipped per-operator tally


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of ``size`` ranks on torch's ``fake``
    backend, this process rank 0, for the body; one already there of that
    size and backend is used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != size:
            raise RuntimeError(
                f"a {dist.get_backend()} group of {dist.get_world_size()} "
                f"ranks exists; the dry-run needs a fake one of {size}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_like(shape, dtype, sh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.zeros(shape, dtype=dtype), sh.mesh,
                             sh.placements, src_data_rank=None)


def _to_bf16(params):
    """Cast float32 parameters of 2+ dims to bf16 in place (serving
    deployments ship bf16 weights; fp32 masters are a training artifact)."""
    from torch import nn

    for module in params.modules():
        for name, p in list(module._parameters.items()):
            if p.dtype == torch.float32 and p.dim() >= 2:
                module._parameters[name] = nn.Parameter(
                    p.detach().to(torch.bfloat16), requires_grad=False)


def _mem_tracker():
    """A ``MemTracker`` that tracks one rank's local tensors only: the
    global-shape ops of DTensor's shape propagation, which run under the
    step's own fake mode, are not its memory."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    from repro_torch.roofline.analysis import (
        check_propagation_hook,
        in_sharding_propagation,
    )

    check_propagation_hook()

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(issubclass(t, DTensor) for t in types) \
                    and in_sharding_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def _memory(mt, before: int, after: int) -> dict:
    peak = mt.get_tracker_snapshot("peak")
    dev, snap = max(peak.items(), key=lambda kv: kv[1].get("Total", 0))
    total = int(snap.get("Total", 0))
    return {"arguments": before, "outputs": after,
            "temps": total - before, "peak": total,
            "by_kind_at_peak": {str(k): int(v) for k, v in snap.items()}}


def _total(mt) -> int:
    return max((int(s.get("Total", 0)) for s in
                mt.get_tracker_snapshot("current").values()), default=0)


def lower_cell(arch: str, shape_name: str, *, multi_pod=False,
               plan: shlib.Plan = shlib.DEFAULT_PLAN,
               cfg_overrides: dict | None = None,
               verbose=True, hbm_limit: float | None = None,
               dump_dir: str | None = None) -> CellResult:
    mesh_desc = "2x16x16" if multi_pod else "16x16"
    cfg = config_base.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, reason = applicable(cfg, shape_name)
    if not ok:
        return CellResult(arch, shape_name, mesh_desc, "skipped", reason)
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        return _lower(cfg, arch, shape_name, mesh_desc, multi_pod, plan,
                      verbose, hbm_limit, dump_dir)


def _lower(cfg, arch, shape_name, mesh_desc, multi_pod, plan, verbose,
           hbm_limit, dump_dir) -> CellResult:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import named_leaves

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    model = build_model(cfg, device="cpu")
    seq, gbatch, kind = SHAPES[shape_name]
    ba = batch_axes(mesh)
    act_rules = plan.act_rule_map(mesh, seq_shard=(kind != "decode"))
    act_rules["batch"] = ba
    counter = OpCounter()
    mt = _mem_tracker()

    with FakeTensorMode(), implicit_replication():
        params = model.init(torch.Generator())
        if kind != "train":
            _to_bf16(params)
        shlib.shard_params(model, params, mesh, plan)
        structs, input_sh = input_specs(cfg, shape_name, mesh)
        T.set_mesh_rules(mesh, act_rules)
        try:
            if kind == "train":
                params.requires_grad_()
                opt = make_optimizer(cfg.optimizer, total_steps=1000)
                opt_state = opt.init(params)
                opt_state = shlib.shard_tree(opt_state, shlib.mirror_opt_shardings(
                    shlib.param_shardings(model, params, mesh, plan),
                    opt_state, mesh))
                M = max(cfg.microbatches, 1)
                # gradient accumulation: activations live for one
                # microbatch at a time; fp32 grads accumulate
                mb_structs, mb_sh = _microbatch_specs(cfg, shape_name, mesh, M)
                batches = [{k: _fake_like(*mb_structs[k], mb_sh[k])
                            for k in mb_structs} for _ in range(M)]
                named = named_leaves(params)
                mt.track_external(params, *named_leaves(opt_state).values(),
                                  *[t for b in batches for t in b.values()])
                before = _total(mt)
                with mt, counter:
                    gsum = None
                    for mbatch in batches:
                        loss = model.loss(params, mbatch)
                        grads = torch.autograd.grad(
                            loss, list(named.values()), allow_unused=True)
                        grads = [torch.zeros_like(p, dtype=torch.float32)
                                 if g is None else g.float()
                                 for p, g in zip(named.values(), grads)]
                        gsum = grads if gsum is None else [
                            a + b for a, b in zip(gsum, grads)]
                        del loss, grads
                    gsum = [g / M for g in gsum] if M > 1 else gsum
                    opt.update(dict(zip(named, gsum)), opt_state, named, 0)
                    del gsum
                after = _total(mt)
            elif kind == "prefill":
                batch = {k: _fake_like(*structs[k], input_sh[k])
                         for k in structs}
                mt.track_external(params, *batch.values())
                before = _total(mt)
                with torch.no_grad(), mt, counter:
                    out = model.prefill(params, batch)[0]
                after = _total(mt)
                del out
            else:  # decode
                caches = model.init_cache(gbatch, seq)
                caches = shlib.shard_tree(caches, shlib.cache_shardings(
                    caches, mesh, ba))
                batch = {k: _fake_like(*structs[k], input_sh[k])
                         for k in structs}
                extra = {}
                if cfg.enc_layers:
                    n_enc = max(seq // 4, 8) if shape_name != "long_500k" \
                        else 8192
                    extra["enc_out"] = _fake_like(
                        (gbatch, n_enc, cfg.d_model),
                        getattr(torch, cfg.act_dtype),
                        shlib.Sharding(mesh, shlib.guard_spec(
                            (gbatch, n_enc, cfg.d_model),
                            (ba, "model", None), mesh)))
                    extra["enc_positions"] = _fake_like(
                        (gbatch, n_enc), torch.int32,
                        shlib.Sharding(mesh, shlib.guard_spec(
                            (gbatch, n_enc), (ba, "model"), mesh)))
                mt.track_external(params, *named_leaves(caches).values(),
                                  *batch.values(), *extra.values())
                before = _total(mt)
                with torch.no_grad(), mt, counter:
                    out = model.decode_step(params, batch["tokens"], caches,
                                            batch["pos"], **extra)
                after = _total(mt)
                del out
        finally:
            T.clear_mesh_rules()
    memory = _memory(mt, before, after)
    counts = counter.report()
    if hbm_limit is None and not torch.cuda.is_available():
        hbm_limit = H100_HBM_BYTES
    if verbose:
        print(f"[{arch}/{shape_name}/{mesh_desc}] memory per rank: "
              f"{memory}")
        print(f"[{arch}/{shape_name}/{mesh_desc}] counts per rank: "
              f"flops={counts['flops']:.3e} "
              f"bytes={counts['bytes_accessed']:.3e}")
    report = roofline_from_step(
        counts, arch=arch, shape=shape_name, mesh_desc=mesh_desc,
        chips=chips, model_flops=model_flops_estimate(cfg, shape_name),
        memory_per_chip=memory, hbm_limit=hbm_limit)
    dump = _dump_ops(counter, f"{arch}_{shape_name}_{mesh_desc}_{plan.name}",
                     dump_dir)
    return CellResult(arch, shape_name, mesh_desc, "ok",
                      seconds=time.time() - t0, report=report.to_dict(),
                      op_dump=dump)


def _microbatch_specs(cfg, shape_name, mesh, M):
    """:func:`input_specs` of one of ``M`` microbatches of the cell."""
    seq, gbatch, kind = SHAPES[shape_name]
    full = make_batch_specs(cfg, gbatch // M, seq,
                            batch_axes=batch_axes(mesh))
    structs = {k: v[:2] for k, v in full.items()}
    return structs, {k: shlib.Sharding(mesh, shlib.guard_spec(
        v[0], v[2], mesh)) for k, v in full.items()}


def _dump_ops(counter, tag: str, dump_dir: str | None = None) -> str:
    """The step's per-operator tally (calls by aten op; FLOPs, and a
    collective's bytes, by op and operand shapes) and its totals,
    gzipped JSON under ``dump_dir`` (default ``$REPRO_TORCH_OP_DUMP_DIR``
    or ``build/op_dumps``); the path, or "" if it cannot be written."""
    d = dump_dir or os.environ.get("REPRO_TORCH_OP_DUMP_DIR",
                                   os.path.join("build", "op_dumps"))
    path = os.path.join(d, re.sub(r"[^A-Za-z0-9_.-]", "_", tag) + ".json.gz")
    try:
        os.makedirs(d, exist_ok=True)
        with gzip.open(path, "wt") as f:
            json.dump({"ops": dict(counter.ops.most_common()),
                       "flops_or_bytes_by_shape": dict(
                           counter.by_shape.most_common()),
                       **counter.report()}, f)
    except OSError:
        return ""
    return path


def run_all(archs=None, shapes=None, meshes=(False, True),
            results_path=RESULTS_PATH):
    archs = archs or config_base.all_archs()
    shapes = shapes or list(SHAPES)
    try:
        with open(results_path) as f:
            results = json.load(f)
    except FileNotFoundError:
        results = {}
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                key = f"{arch}|{shape}|{'2x16x16' if multi_pod else '16x16'}"
                if key in results and results[key]["status"] in ("ok", "skipped"):
                    continue
                print(f"=== {key} ===", flush=True)
                try:
                    res = lower_cell(arch, shape, multi_pod=multi_pod)
                except Exception as e:
                    traceback.print_exc()
                    res = CellResult(arch, shape,
                                     "2x16x16" if multi_pod else "16x16",
                                     "failed", reason=f"{type(e).__name__}: {e}")
                results[key] = dataclasses.asdict(res)
                _save(results, results_path)
                print(f"--- {key}: {res.status} ({res.seconds:.1f}s) "
                      f"{res.reason}", flush=True)
    return results


def _save(results: dict, path: str):
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--results", default=RESULTS_PATH)
    ap.add_argument("--plan", default="baseline",
                    choices=list(shlib.PLAN_VARIANTS))
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. kv_block=2048)")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            pass
        overrides[k] = v
    if args.all:
        run_all(results_path=args.results,
                archs=[args.arch] if args.arch else None,
                shapes=[args.shape] if args.shape else None)
        return
    try:
        res = lower_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                         plan=shlib.PLAN_VARIANTS[args.plan],
                         cfg_overrides=overrides or None)
    except Exception as e:
        traceback.print_exc()
        res = CellResult(args.arch, args.shape,
                         "2x16x16" if args.multi_pod else "16x16",
                         "failed", reason=f"{type(e).__name__}: {e}")
    print(json.dumps(dataclasses.asdict(res), indent=2))
    # merge into the results cache so per-cell subprocess driving works
    try:
        with open(args.results) as f:
            results = json.load(f)
    except FileNotFoundError:
        results = {}
    key = f"{args.arch}|{args.shape}|{res.mesh}"
    if args.plan != "baseline" or overrides:
        key += f"|{args.plan}" + (
            "|" + ";".join(f"{k}={v}" for k, v in overrides.items())
            if overrides else "")
    results[key] = dataclasses.asdict(res)
    _save(results, args.results)


if __name__ == "__main__":
    main()
