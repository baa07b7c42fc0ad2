"""Cold-start gate: a fresh replica warm-loads the design store >= 10x
faster than ranking and building from scratch, with a bitwise-identical
result -- the port's counterpart of ``benchmarks/cold_start.py``.

The persistent :class:`repro_torch.runtime.DesignStore` keeps the
expensive artifacts across processes: the tuned ranking and, on a card,
the built tile kernel's library (the store's ``cuda_so`` tier).  Two
fresh child processes serve one request each against one store:

  1. **cold child** -- an empty store: ranks the design space, builds the
     kernel (``nvcc`` on a card) and writes both to the store;
  2. **warm child** -- the same store: must reach its first result with
     zero rankings and zero compiles (``autotune_calls == 0``,
     ``jit_builds == 0`` and ``nvcc_compiles == 0``), at least one store
     hit, >= 10 x faster than the cold child, and a bitwise-equal result.

Each child's kernel build root is private and empty, so only the store
can spare the warm side ``nvcc``.  Time to first result is measured
inside each child, from after its imports to the first completed result;
on a card it includes creating the CUDA context, which both sides pay
and which bounds the ratio.  The counters read are the ones the server's
``stats()`` and ``cuda_build.build_many.compiles`` already keep.
:func:`run_cold_start` takes the DSL to serve: the reference's 256x128
grid by default, the paper's 9720x1024 in ``chip_smoke.py``'s phase
``cold_start``.

    PYTHONPATH=src:. python benchmarks_torch/cold_start.py --device cpu --check

On the CPU the store holds rankings only: there is no kernel to build.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

DSL = """
kernel: JACOBI2D_COLDSTART
iteration: 32
input float: in_1(256, 128)
output float: out_1(0,0) = (in_1(0,1) + in_1(1,0) + in_1(0,0)
    + in_1(0,-1) + in_1(-1,0)) / 5
"""


def _child(device: str, dsl: str, store_dir: str, build_root: str,
           out_npy: str, report_json: str) -> None:
    """One serving replica: store-backed server, one request, one result.

    Everything a replica pays between "process is up" and "first result
    returned" is inside the timed region: the server and its store-backed
    cache, registration (ranking or store hit) and the first dispatch
    (kernel build or store load, then the run).  The report breaks that
    time down and carries the store's and the kernels' counters."""
    from repro_torch.core.dsl import parse
    from repro_torch.kernels import cuda_build, pipeline, stencil
    from repro_torch.serve import StencilRequest, StencilServer

    cuda_build.BUILD_ROOT = pathlib.Path(build_root)
    if cuda_build.BUILD_ROOT.exists():
        raise RuntimeError(f"cold_start: build root {build_root} is not empty")
    spec = parse(dsl)
    rng = np.random.default_rng(42)
    arrays = {
        name: rng.standard_normal(shape).astype(dt)
        for name, (dt, shape) in spec.inputs.items()
    }
    # where the warm side's time goes: the library's write and load
    install = cuda_build.install_library
    install_s = []

    def timed_install(key, blob):
        t = time.perf_counter()
        try:
            return install(key, blob)
        finally:
            install_s.append(time.perf_counter() - t)

    cuda_build.install_library = timed_install

    t0 = time.perf_counter()
    srv = StencilServer(max_batch=1, store_dir=store_dir, device=device)
    t1 = time.perf_counter()
    srv.register("jacobi2d", spec)
    t2 = time.perf_counter()
    out = np.asarray(srv.serve([StencilRequest("jacobi2d", arrays)])[0])
    t3 = time.perf_counter()

    srv.persist_telemetry()
    np.save(out_npy, out)
    st = srv.stats()
    report = {
        "first_result_s": t3 - t0,
        "server_s": t1 - t0,          # CUDA context, store open
        "register_s": t2 - t1,        # ranking or store, kernel, warmup
        "warmup_s": st["jacobi2d"]["warmup_time_s"],   # first dispatch
        "install_s": sum(install_s),  # store blob -> build root -> dlopen
        "library_bytes": sum(f.stat().st_size for f in
                             pathlib.Path(build_root).glob("*/libsasa.so")),
        "serve_s": t3 - t2,
        "autotune_calls": st["_cache"]["autotune_calls"],
        "jit_builds": st["_cache"]["jit_builds"],
        "nvcc_compiles": cuda_build.build_many.compiles,
        "store_hits": st["_cache"]["store_hits"],
        "store": st.get("_store", {}),
        "launches": stencil.stencil_cuda.launches
        + pipeline.stencil_cuda_batched.launches,
        "finite": bool(np.isfinite(out).all()),
    }
    with open(report_json, "w") as f:
        json.dump(report, f)


def _spawn(device: str, dsl: str, store_dir: str, build_root: str,
           out_npy: str, report_json: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    subprocess.run(
        [sys.executable, str(ROOT / "benchmarks_torch" / "cold_start.py"),
         "--child", device, dsl, store_dir, build_root, out_npy, report_json],
        check=True, env=env, cwd=str(ROOT), timeout=600,
    )
    with open(report_json) as f:
        return json.load(f)


def run_cold_start(rows, gates, dev, dsl: str = DSL) -> dict:
    """Serve ``dsl``'s grid from a cold and then a warm child over one
    fresh store; record the gates and return both children's reports."""
    from benchmarks_torch.common import emit

    with tempfile.TemporaryDirectory() as td:
        store = os.path.join(td, "store")
        sides = {}
        for side in ("cold", "warm"):
            report = _spawn(dev.type, dsl, store,
                            os.path.join(td, f"kernels_{side}"),
                            os.path.join(td, f"{side}.npy"),
                            os.path.join(td, f"{side}.json"))
            sides[side] = (np.load(os.path.join(td, f"{side}.npy")), report)
    (out_cold, cold), (out_warm, warm) = sides["cold"], sides["warm"]

    ratio = cold["first_result_s"] / warm["first_result_s"]
    emit(rows, "coldstart/cold_first_result", cold["first_result_s"] * 1e6,
         f"autotune_calls={cold['autotune_calls']}; "
         f"jit_builds={cold['jit_builds']}; "
         f"nvcc_compiles={cold['nvcc_compiles']} (fresh store, {dev.type})")
    emit(rows, "coldstart/warm_first_result", warm["first_result_s"] * 1e6,
         f"autotune_calls={warm['autotune_calls']}; "
         f"jit_builds={warm['jit_builds']}; "
         f"nvcc_compiles={warm['nvcc_compiles']}; "
         f"store_hits={warm['store_hits']}")
    emit(rows, "coldstart/speedup", 0.0,
         f"{ratio:.1f}x warm vs cold (subprocess, gate >= 10x)")

    bitwise = bool(np.array_equal(out_cold, out_warm))
    emit(rows, "coldstart/bitwise", 0.0,
         "bitwise-identical" if bitwise else "MISMATCH")

    gates.correctness("cold_start/bitwise", bitwise)
    gates.correctness("cold_start/finite", cold["finite"] and warm["finite"])
    gates.correctness("cold_start/cold_autotune_calls",
                      cold["autotune_calls"], ">=", 1)
    gates.correctness("cold_start/warm_autotune_calls",
                      warm["autotune_calls"], "==", 0)
    gates.correctness("cold_start/warm_jit_builds", warm["jit_builds"],
                      "==", 0)
    gates.correctness("cold_start/warm_nvcc_compiles", warm["nvcc_compiles"],
                      "==", 0)
    gates.correctness("cold_start/warm_store_hits", warm["store_hits"],
                      ">=", 1)
    if dev.type == "cuda":
        gates.correctness("cold_start/cold_jit_builds", cold["jit_builds"],
                          ">=", 1)
        gates.correctness("cold_start/cold_nvcc_compiles",
                          cold["nvcc_compiles"], ">=", 1)
        gates.correctness("cold_start/warm_executable_hits",
                          warm["store"].get("executable_hits", 0), ">=", 1)
        gates.correctness("cold_start/tile_kernel_launches",
                          min(cold["launches"], warm["launches"]), ">=", 1)
    gates.timing("cold_start/cold_over_warm", ratio, ">=", 10.0)
    return {"cold": cold, "warm": warm, "cold_over_warm": ratio,
            "bitwise": bitwise}


def run(check: bool = False, smoke: bool = False, device=None, gates=None):
    # the trace is already CI-sized; smoke changes nothing, the flag
    # exists so the harness and CI call it as they call the others
    from benchmarks_torch.common import Gates
    from repro_torch.kernels.ops import resolve_device

    del smoke
    gates = Gates() if gates is None else gates
    rows = []
    run_cold_start(rows, gates, resolve_device(device))
    if check:
        gates.assert_held()
    return rows


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        _child(*sys.argv[2:8])
        sys.exit(0)
    from benchmarks_torch.common import main

    sys.exit(main(
        run, sys.argv[1:], __doc__,
        "OK: warm replica reached its first bitwise-identical result "
        ">=10x faster than a cold one, with zero rankings and zero "
        "compiles"))
