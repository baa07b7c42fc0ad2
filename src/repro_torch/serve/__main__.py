"""``python -m repro_torch.serve`` -- the replicated serving tier's entry point.

Two modes:

  * ``--worker`` (what :class:`repro_torch.serve.StencilRouter` spawns):
    run one replica -- a :class:`StencilServer` over the shared persistent
    store plus a continuous-batching :class:`StencilScheduler` -- on
    ``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
    versions) and speak the router's length-prefixed pickle protocol on
    stdin/stdout.  File descriptor 1 is re-pointed at stderr before torch
    is imported, so stray prints can never corrupt the protocol stream.
    A worker asked for ``cuda`` on a host without CUDA exits non-zero; it
    never serves on the CPU instead.

  * default: a self-contained demo -- spawn a small router fleet over a
    store directory, register a Jacobi kernel, push a trace through it,
    and print per-replica stats.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading


def _worker(args) -> int:
    # Claim fd 1 for the protocol BEFORE importing torch: anything that
    # prints to stdout afterwards lands on stderr instead of the wire.
    proto_out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"worker: --device {args.device} but CUDA is not available",
              file=sys.stderr)
        return 2

    from repro_torch.kernels import pipeline, stencil
    from repro_torch.serve.engine import StencilRequest, StencilServer
    from repro_torch.serve.router import read_frame, write_frame
    from repro_torch.serve.scheduler import StencilScheduler

    server = StencilServer(
        max_batch=args.max_batch,
        max_inflight=args.max_inflight,
        bucketing=args.bucketing,
        warmup=args.warmup,
        store_dir=args.store,
        device=args.device,
    )
    scheduler = StencilScheduler(server)
    out_lock = threading.Lock()
    stdin = sys.stdin.buffer

    def reply(msg_id, ok, result=None, error=None):
        write_frame(
            proto_out,
            {"id": msg_id, "ok": ok, "result": result, "error": error},
            out_lock,
        )

    def handle_submit(msg):
        try:
            ticket = scheduler.submit(
                StencilRequest(msg["design"], msg["arrays"]),
                lane=msg.get("lane"),
                tenant=msg.get("tenant") or "default",
            )
        except Exception as e:
            reply(msg["id"], False, error=e)
            return

        def wait():
            try:
                reply(msg["id"], True, result=ticket.result(timeout=600.0))
            except Exception as e:
                reply(msg["id"], False, error=e)

        # replies are per-ticket and out-of-order by design: the router
        # matches them by id, so a slow batch never blocks a fast one
        threading.Thread(target=wait, daemon=True).start()

    while True:
        msg = read_frame(stdin)
        if msg is None:                   # router hung up
            break
        op = msg.get("op")
        try:
            if op == "submit":
                handle_submit(msg)
            elif op == "register":
                reg = server.register(
                    msg["name"], msg["spec"], iterations=msg["iterations"],
                    bucketing=msg.get("bucketing"),
                )
                reply(msg["id"], True, result={
                    "cache_hit": reg.counters.cache_hit,
                    "bucketed": reg.bucketed,
                })
            elif op == "ping":
                st = server.stats()
                reply(msg["id"], True, result={
                    "pid": os.getpid(),
                    "scheduler": scheduler.stats(),
                    "cache": st["_cache"],
                    "store": st.get("_store", {}),
                    "launches": {
                        "stencil_cuda": stencil.stencil_cuda.launches,
                        "stencil_cuda_batched":
                            pipeline.stencil_cuda_batched.launches,
                    },
                })
            elif op == "drain":
                scheduler.drain()
                reply(msg["id"], True)
            elif op == "exit":
                scheduler.close()
                reply(msg["id"], True)
                break
            else:
                reply(msg["id"], False, error=ValueError(f"bad op {op!r}"))
        except Exception as e:
            reply(msg["id"], False, error=e)
    scheduler.close()
    return 0


def _demo(args) -> int:
    import tempfile

    import numpy as np

    from repro_torch.configs import stencils
    from repro_torch.serve.engine import StencilRequest
    from repro_torch.serve.router import StencilRouter

    rng = np.random.default_rng(0)
    spec = stencils.jacobi2d(shape=(32, 16), iterations=2)
    store = args.store or tempfile.mkdtemp(prefix="sasa-store-")
    print(f"router: {args.replicas} replicas on {args.device} over store "
          f"{store}")
    with StencilRouter(
        store, replicas=args.replicas, max_batch=args.max_batch,
        device=args.device,
    ) as router:
        router.register("jacobi", spec)
        reqs = [
            StencilRequest("jacobi", {
                n: rng.standard_normal(shape).astype(dt)
                for n, (dt, shape) in spec.inputs.items()
            })
            for _ in range(8)
        ]
        outs = router.serve(reqs)
        print(f"served {len(outs)} grids, first checksum "
              f"{float(np.sum(outs[0])):.6f}")
        for name, info in router.ping().items():
            sched = info.get("scheduler", {})
            cache = info.get("cache", {})
            print(f"  {name}: healthy={info.get('healthy')} "
                  f"completed={sched.get('completed')} "
                  f"autotune_calls={cache.get('autotune_calls')} "
                  f"jit_builds={cache.get('jit_builds')}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="replicated stencil-serving tier "
                    "(worker protocol or demo fleet)",
    )
    parser.add_argument("--worker", action="store_true",
                        help="run one router-spawned replica on stdio")
    parser.add_argument("--store", default=None,
                        help="shared DesignStore directory")
    parser.add_argument("--device", default="cuda",
                        help="device the replica serves on (cuda or cpu)")
    parser.add_argument("--max-batch", type=int, default=4)
    parser.add_argument("--max-inflight", type=int, default=2)
    parser.add_argument("--bucketing", action="store_true")
    parser.add_argument("--warmup", action="store_true")
    parser.add_argument("--replicas", type=int, default=2,
                        help="demo mode: fleet size")
    args = parser.parse_args(argv)
    if args.worker:
        if not args.store:
            parser.error("--worker requires --store")
        return _worker(args)
    return _demo(args)


if __name__ == "__main__":
    sys.exit(main())
