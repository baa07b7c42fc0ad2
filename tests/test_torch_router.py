"""The port's replicated serving tier against the reference's contracts:
worker protocol, routing, health, handoff, warm replicas.

Every test here spawns ``python -m repro_torch.serve --worker --device
cpu`` subprocesses (each imports torch), so the whole module is
slow-marked, as the reference's ``tests/test_router.py`` is.  Results are
held bitwise against the port's in-process synchronous ``serve()`` and
within 2e-4 of the reference's oracle.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import dsl as ref_dsl
from repro.kernels import ref as ref_kernels

import repro_torch
from repro_torch.configs import stencils
from repro_torch.core import dsl
from repro_torch.runtime import DesignCache
from repro_torch.serve import StencilRequest, StencilServer
from repro_torch.serve.router import (
    ReplicaDied,
    StencilRouter,
    read_frame,
    write_frame,
)

pytestmark = pytest.mark.slow

RNG = np.random.default_rng(31)
ITERS = 2


def spec_16x8():
    return stencils.jacobi2d(shape=(16, 8), iterations=ITERS)


def grid_request(design, spec):
    return StencilRequest(design, {
        n: RNG.standard_normal(shape).astype(dt)
        for n, (dt, shape) in spec.inputs.items()
    })


def oracle(spec, req):
    rspec = ref_dsl.parse(dsl.format_spec(spec))
    return np.asarray(ref_kernels.stencil_iterations_ref(
        rspec, {n: np.asarray(a) for n, a in req.arrays.items()}, ITERS))


def in_process(spec, reqs, **kw):
    """The port's synchronous serve() of the same requests."""
    srv = StencilServer(max_batch=2, cache=DesignCache(), device="cpu", **kw)
    srv.register("jac", spec)
    return srv.serve(reqs)


def wait_until(predicate, timeout_s=30.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not reached in {timeout_s}s")
        time.sleep(0.05)


def worker_env():
    src_dir = str(Path(next(iter(repro_torch.__path__))).parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = src_dir + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    return env


def test_worker_protocol_roundtrip(tmp_path):
    """Speak the framed pickle protocol to one bare worker: ping,
    register, submit, exit -- replies matched by id, grid correct."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "--worker",
         "--store", str(tmp_path / "store"), "--max-batch", "2",
         "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=worker_env(),
    )
    try:
        spec = spec_16x8()
        write_frame(proc.stdin, {"id": 0, "op": "ping"})
        pong = read_frame(proc.stdout)
        assert pong["id"] == 0 and pong["ok"]
        assert pong["result"]["pid"] == proc.pid

        write_frame(proc.stdin, {
            "id": 1, "op": "register", "name": "jac", "spec": spec,
            "iterations": None,
        })
        reg = read_frame(proc.stdout)
        assert reg["id"] == 1 and reg["ok"]

        req = grid_request("jac", spec)
        write_frame(proc.stdin, {
            "id": 2, "op": "submit", "design": "jac",
            "arrays": req.arrays, "lane": None, "tenant": "default",
        })
        out = read_frame(proc.stdout)
        assert out["id"] == 2 and out["ok"]
        np.testing.assert_allclose(
            out["result"], oracle(spec, req), rtol=2e-4, atol=2e-4
        )
        np.testing.assert_array_equal(out["result"],
                                      in_process(spec, [req])[0])

        write_frame(proc.stdin, {"id": 3, "op": "exit"})
        ack = read_frame(proc.stdout)
        assert ack["id"] == 3 and ack["ok"]
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_cuda_worker_without_cuda_exits_nonzero(tmp_path):
    """A worker asked for the card on a host without one refuses to
    start; it never serves on the CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--worker",
         "--store", str(tmp_path / "store"), "--device", "cuda"],
        stdin=subprocess.DEVNULL, capture_output=True, env=worker_env(),
        timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == b""                   # nothing on the wire
    assert b"CUDA is not available" in proc.stderr


def test_router_fleet_serves_and_health_checks(tmp_path):
    spec = spec_16x8()
    with StencilRouter(tmp_path / "store", replicas=2, max_batch=2,
                       device="cpu") as router:
        router.register("jac", spec)
        reqs = [grid_request("jac", spec) for _ in range(5)]
        outs = router.serve(reqs)
        for req, out, want in zip(reqs, outs, in_process(spec, reqs)):
            np.testing.assert_allclose(
                out, oracle(spec, req), rtol=2e-4, atol=2e-4
            )
            np.testing.assert_array_equal(out, want)
        health = router.ping()
        assert set(health) == {"replica-0", "replica-1"}
        assert all(info["healthy"] for info in health.values())
        served = sum(
            info["scheduler"]["completed"] for info in health.values()
        )
        assert served == 5
        # the first replica ranked and wrote the store; the second
        # registered warm from it
        first, second = (health[f"replica-{i}"]["cache"] for i in (0, 1))
        assert first["autotune_calls"] >= 1
        assert second["autotune_calls"] == 0 and second["store_hits"] >= 1
        assert first["jit_builds"] == second["jit_builds"] == 0
    # close() reaps every worker
    assert all(r.proc.poll() is not None for r in router._replicas)


def test_router_reroutes_after_replica_death(tmp_path):
    """Kill the replica that owns the design: routing skips the corpse
    and requests keep resolving on the survivor."""
    spec = spec_16x8()
    with StencilRouter(tmp_path / "store", replicas=2, max_batch=2,
                       device="cpu") as router:
        router.register("jac", spec)
        owner = router._route("jac")
        router.serve([grid_request("jac", spec)])

        owner.proc.kill()
        wait_until(lambda: not owner.healthy, what="death detection")

        reqs = [grid_request("jac", spec) for _ in range(3)]
        outs = router.serve(reqs)
        for req, out in zip(reqs, outs):
            np.testing.assert_allclose(
                out, oracle(spec, req), rtol=2e-4, atol=2e-4
            )
        survivor = router._route("jac")
        assert survivor is not owner and survivor.healthy
        health = router.ping()
        assert health[owner.name] == {"healthy": False}
        assert health[survivor.name]["healthy"]


def test_router_hands_off_inflight_requests_on_death(tmp_path):
    """Requests in flight on a replica when it dies are re-routed whole to
    a survivor (registration replayed first): the client's futures
    resolve without resubmission, bitwise equal to in-process serving."""
    spec = spec_16x8()
    with StencilRouter(tmp_path / "store", replicas=2, max_batch=2,
                       device="cpu") as router:
        router.register("jac", spec)
        owner = router._route("jac")
        reqs = [grid_request("jac", spec) for _ in range(4)]
        futures = [router.submit(r) for r in reqs]
        owner.proc.kill()
        for fut, want in zip(futures, in_process(spec, reqs)):
            np.testing.assert_array_equal(fut.result(timeout=120.0), want)


def test_router_fails_cleanly_with_no_survivors(tmp_path):
    spec = spec_16x8()
    router = StencilRouter(tmp_path / "store", replicas=1, max_batch=2,
                           device="cpu")
    try:
        router.register("jac", spec)
        only = router._route("jac")
        future = router.submit(grid_request("jac", spec))
        only.proc.kill()
        wait_until(lambda: not only.healthy, what="death detection")
        # the one in-flight future either resolved before the kill or
        # fails with ReplicaDied -- it must not hang
        try:
            future.result(timeout=60.0)
        except ReplicaDied:
            pass
        with pytest.raises(ReplicaDied):
            router.submit(grid_request("jac", spec))
    finally:
        router.close()


def test_router_bucketed_registration_matches_in_process(tmp_path):
    """A per-registration bucketer travels to the workers: mixed shapes
    route through bucket designs, bitwise equal to in-process serving."""
    from repro_torch.runtime import ShapeBucketer

    spec = spec_16x8()
    bucketer = ShapeBucketer(ladder=((16, 32), (16, 32)))
    rng = np.random.default_rng(3)
    reqs = [StencilRequest("jac", {"in_1": rng.standard_normal(s).astype(
        np.float32)}) for s in [(16, 8), (12, 20), (30, 9), (16, 8)]]
    with StencilRouter(tmp_path / "store", replicas=2, max_batch=2,
                       device="cpu") as router:
        router.register("jac", spec, bucketing=bucketer)
        outs = router.serve(reqs)
    for out, want, req in zip(outs, in_process(spec, reqs,
                                               bucketing=bucketer), reqs):
        assert out.shape == req.arrays["in_1"].shape
        np.testing.assert_array_equal(out, want)
