"""Serve stencil workloads through the cached, batched, bucketed runtime —
the PyTorch/CUDA port's counterpart of ``examples/serve_stencils.py``.

Part 1 registers two exact-shape designs (auto-tuned once each), pushes a
mixed stream of requests through the micro-batching server, and prints
the per-design counters — including the design-cache hit a second server
observes.

Part 2 is the multi-geometry path: ONE bucketed registration serves a
trace of many distinct grid shapes.  Requests are routed to padded
canonical bucket shapes (powers of two here), one masked design is
compiled per bucket actually hit, and grids of different sizes sharing a
bucket ride the same micro-batch.  The bucket-ladder policy trades
compile time against padded compute: coarser rungs -> fewer compiled
designs but more wasted padding FLOPs/bytes (up to ~4x for a 2-D grid
just past a rung); a finer `ShapeBucketer(ladder=...)` caps the waste at
the cost of more designs.  Dispatch is async double-buffered: the host
stages micro-batch N+1 while the device executes micro-batch N.

Part 3 serves the full boundary matrix through bucketing: replicate-edge
image filters (streamed halo-index gathers re-impose the clamped edge
in-kernel) and a periodic torus kernel (the wrapped extension of each
real grid is host-streamed into the bucket's halo margin) share the same
bucketed micro-batch loop as the zero-boundary traffic — one logical
registration per kernel, any feasible geometry.

Part 4 is the warm restart: a server pointed at a persistent store
directory (`store_dir=`) writes its tuned rankings and AOT-serialized
executables (on a card, the tile kernel's ``nvcc``-built library) through
to disk, and a "restarted" server (fresh cache, same directory) reaches
its first bitwise-identical result without ranking a single candidate or
compiling a single program.

Every served result is also held bitwise against single-shot ``serve()``
of the same request on the same server.

    PYTHONPATH=src python examples_torch/serve_stencils.py               # a CUDA card
    PYTHONPATH=src python examples_torch/serve_stencils.py --device cpu  # plain versions
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.kernels.ops import resolve_device
from repro_torch.runtime import DesignCache
from repro_torch.serve import StencilRequest, StencilServer

JACOBI = """
kernel: JACOBI2D
iteration: 8
input float: in_1(512, 256)
output float: out_1(0,0) = (in_1(0,1) + in_1(1,0) + in_1(0,0)
    + in_1(0,-1) + in_1(-1,0)) / 5
"""

BLUR = """
kernel: BLUR
iteration: 4
input float: in_1(512, 256)
local float: tmp(0,0) = (in_1(-1,0) + in_1(0,0) + in_1(1,0)) / 3
output float: out_1(0,0) = (tmp(0,-1) + tmp(0,0) + tmp(0,1)) / 3
"""


def single_shot_bitwise(srv, reqs, outs) -> bool:
    """Every batched result equals serving its request alone, bitwise."""
    return all(np.array_equal(o, srv.serve([r])[0])
               for r, o in zip(reqs, outs))


def exact_shape_demo(rng, device, iterations):
    print("== exact-shape serving (one design per registered geometry) ==")
    cache = DesignCache()
    srv = StencilServer(max_batch=4, cache=cache, device=device)
    for name, dsl in [("jacobi", JACOBI), ("blur", BLUR)]:
        reg = srv.register(name, dsl, iterations=iterations)
        cfg = reg.config
        print(f"registered {name!r}: {cfg.variant} (k={cfg.k}, s={cfg.s}), "
              f"build {reg.counters.build_time_s * 1e3:.0f} ms, "
              f"warmup {reg.counters.warmup_time_s * 1e3:.0f} ms")

    def req(design):
        spec = srv.design(design).spec
        return StencilRequest(design, {
            n: rng.standard_normal(shape).astype(dt)
            for n, (dt, shape) in spec.inputs.items()
        })

    stream = [req("jacobi"), req("blur"), req("jacobi"), req("jacobi"),
              req("blur"), req("jacobi"), req("jacobi")]
    outs = srv.serve(stream)
    print(f"\nserved {len(outs)} requests; per-design counters:")
    for name, st in srv.stats().items():
        if name == "_cache":
            print(f"  cache: {st['hits']} hits / {st['misses']} misses "
                  f"({st['entries']} entries)")
        else:
            print(f"  {name}: {st['requests']} grids in {st['batches']} "
                  f"batches (+{st['padded_grids']} pad), "
                  f"mean dispatch {st['exec_mean_s'] * 1e3:.1f} ms")

    # a second server sharing the cache skips ranking and jitting entirely
    srv2 = StencilServer(max_batch=4, cache=cache, device=device)
    reg2 = srv2.register("jacobi", JACOBI, iterations=iterations)
    print(f"\nsecond server register('jacobi'): cache_hit="
          f"{reg2.counters.cache_hit}, build "
          f"{reg2.counters.build_time_s:.3f} s")
    bitwise = single_shot_bitwise(srv, stream, outs)
    print(f"bitwise equal to single-shot serve(): {bitwise}")
    return {"second_cache_hit": reg2.counters.cache_hit,
            "bitwise": bitwise}


def bucketed_demo(rng, device, iterations):
    print("\n== bucketed serving (one registration, many geometries) ==")
    cache = DesignCache()
    srv = StencilServer(max_batch=4, cache=cache, bucketing=True,
                        device=device)
    reg = srv.register("jacobi", JACOBI, iterations=iterations)
    print(f"registered 'jacobi' as a logical kernel "
          f"(warm bucket: {sorted(reg.cached.buckets)})")

    # a mixed-shape request trace: distinct geometries, few buckets
    shapes = [(512, 256), (300, 200), (257, 129), (120, 80), (500, 250),
              (260, 140), (100, 33), (444, 222), (65, 65), (512, 256)]
    reqs = [
        StencilRequest("jacobi", {
            "in_1": rng.standard_normal(s).astype(np.float32)
        })
        for s in shapes
    ]
    outs = srv.serve(reqs)
    assert all(o.shape == s for o, s in zip(outs, shapes))
    st = srv.stats()["jacobi"]
    print(f"served {len(shapes)} grids of {len(set(shapes))} distinct "
          f"shapes in {st['batches']} micro-batches from "
          f"{st['compiled_buckets']} compiled bucket designs:")
    for bucket, bst in sorted(st["buckets"].items()):
        print(f"  bucket {bucket}: {bst['requests']} grids, "
              f"{bst['hits']} hits / {bst['misses']} compiles "
              f"(build {bst['build_time_s'] * 1e3:.0f} ms)")
    print("bucket-ladder policy: powers of two per dim -> few designs, "
          "padded compute; pass ShapeBucketer(ladder=...) to trade the "
          "other way")
    bitwise = single_shot_bitwise(srv, reqs, outs)
    print(f"bitwise equal to single-shot serve(): {bitwise}")
    return {"bitwise": bitwise}


BLUR_REPLICATE = """
kernel: BLUR-REPLICATE
iteration: 4
boundary: replicate
input float: in_1(128, 96)
output float: out_1(0,0) = (in_1(-1,-1) + in_1(-1,0) + in_1(-1,1)
    + in_1(0,-1) + in_1(0,0) + in_1(0,1)
    + in_1(1,-1) + in_1(1,0) + in_1(1,1)) / 9
"""

HEAT_PERIODIC = """
kernel: HEAT2D-PERIODIC
iteration: 4
boundary: periodic
input float: in_1(128, 96)
output float: out_1(0,0) = in_1(0,0) + 0.125 * (in_1(1,0) + in_1(-1,0)
    + in_1(0,1) + in_1(0,-1) - 4 * in_1(0,0))
"""


def boundary_demo(rng, device, iterations):
    print("\n== bucketed serving across the full boundary matrix ==")
    srv = StencilServer(max_batch=4, cache=DesignCache(), bucketing=True,
                        device=device)
    srv.register("blur_rep", BLUR_REPLICATE, iterations=iterations)
    srv.register("heat_per", HEAT_PERIODIC, iterations=iterations)
    shapes = [(128, 96), (90, 70), (128, 128), (50, 40)]
    reqs = [
        StencilRequest(design, {
            "in_1": rng.standard_normal(s).astype(np.float32)
        })
        for s in shapes for design in ("blur_rep", "heat_per")
    ]
    outs = srv.serve(reqs)
    assert all(o.shape == r.arrays["in_1"].shape
               for o, r in zip(outs, reqs))
    for name, note in [
        ("blur_rep", "replicate edges via streamed halo-index gathers"),
        ("heat_per", "periodic torus via host-streamed wrap margins"),
    ]:
        st = srv.stats()[name]
        print(f"  {name} ({note}): {st['requests']} grids, "
              f"{st['compiled_buckets']} bucket design(s) "
              f"{sorted(st['buckets'])}")
    print("every request carries its own streamed boundary inputs, so "
          "mixed-boundary traffic shares the async micro-batch loop")
    bitwise = single_shot_bitwise(srv, reqs, outs)
    print(f"bitwise equal to single-shot serve(): {bitwise}")
    return {"bitwise": bitwise}


def warm_restart_demo(rng, device, iterations):
    print("\n== persistent store (warm restart from disk) ==")
    grid = {"in_1": rng.standard_normal((512, 256)).astype(np.float32)}

    def replica(store_dir):
        # a fresh StencilServer + DesignCache each time — only the store
        # directory survives, exactly like a server process restarting
        t0 = time.perf_counter()
        srv = StencilServer(max_batch=4, store_dir=store_dir, device=device)
        srv.register("jacobi", JACOBI, iterations=iterations)
        out = srv.serve([StencilRequest("jacobi", dict(grid))])[0]
        dt = time.perf_counter() - t0
        srv.persist_telemetry()
        return srv, out, dt

    with tempfile.TemporaryDirectory() as td:
        srv1, out1, cold_s = replica(td)
        st1 = srv1.stats()["_cache"]
        print(f"cold replica: first result in {cold_s * 1e3:.0f} ms "
              f"(autotune_calls={st1['autotune_calls']}, "
              f"jit_builds={st1['jit_builds']})")

        srv2, out2, warm_s = replica(td)
        st2 = srv2.stats()["_cache"]
        print(f"warm restart: first result in {warm_s * 1e3:.0f} ms "
              f"(autotune_calls={st2['autotune_calls']}, "
              f"jit_builds={st2['jit_builds']}, "
              f"store_hits={st2['store_hits']}) — "
              f"{cold_s / warm_s:.1f}x faster")
        assert np.array_equal(out1, out2), "warm restart must be bitwise"
        print(f"store: {srv2.stats()['_store']}")
        print("outputs bitwise-identical: the warm replica replays the "
              "very executable the cold one compiled; inspect the store "
              "with `python -m repro_torch.store list <dir>`")
        bitwise = single_shot_bitwise(srv2, [StencilRequest(
            "jacobi", dict(grid))], [out2])
        print(f"bitwise equal to single-shot serve(): {bitwise}")
        return {"warm_autotune_calls": st2["autotune_calls"],
                "bitwise": bitwise}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a card) or cpu")
    ap.add_argument("--iterations", type=int, default=None,
                    help="iterations of every kernel (default: each DSL's "
                         "own); shapes, buckets and cache traffic stay")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    run = (rng, device, args.iterations)
    return {"exact": exact_shape_demo(*run),
            "bucketed": bucketed_demo(*run),
            "boundary": boundary_demo(*run),
            "warm_restart": warm_restart_demo(*run)}


if __name__ == "__main__":
    main()
