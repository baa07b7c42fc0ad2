"""Time K1 (stencil_cuda) and the main path from one source tree; prints
one JSON line with a median and a sha256 digest of the output per case.

Compares the tile kernel of two commits on one card.  Unpack the other
commit with ``git archive <commit> | tar -x -C build/parent`` (``build/``
is gitignored), then, in one call on the card, alternate the two sides so
drift on the machine falls on both::

    for side in P C C P P C C P; do
      if [ $side = P ]; then python3 tools/k1_ab_timing.py build/parent/src parent
      else python3 tools/k1_ab_timing.py src change; fi
    done

Each process builds its tree's kernels (into that tree's own ``build/``),
then, per kernel case, takes the median over 10 samples of one round, each
sample 10 launches back to back between CUDA events (so the host's launch
overhead hides behind the device's work), with the tile given explicitly
so both trees run the same geometry.  Per ``SWEEP`` entry it times 16 iterations of JACOBI2D
4096x4096 through the round loop the same way (3 runs per sample).  Per
main-path case it runs ``autotune`` (each tree ranks for itself) and
takes the median over 10 samples of 3 dispatches of the runner.  The
inputs come from one seed, so equal digests on both sides mean bitwise
equal outputs.
"""
import dataclasses
import hashlib
import json
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np  # noqa: E402
import torch  # noqa: E402
from repro_torch.configs import stencils  # noqa: E402
from repro_torch.core import dsl  # noqa: E402
from repro_torch.core.autotune import autotune  # noqa: E402
from repro_torch.core.ir import lower  # noqa: E402
from repro_torch.core.spec import Boundary  # noqa: E402
from repro_torch.kernels import cuda_build, ops, stencil  # noqa: E402
from repro_torch.runtime import bucket_plan  # noqa: E402

# (kernel, shape, s, tile); the ninth is the replicate bucket spec below
CASES = [
    ("jacobi2d", (4096, 4096), 1, (32, 32)),
    ("jacobi2d", (4096, 4096), 4, (32, 32)),
    ("jacobi2d", (4096, 4096), 4, (64, 64)),
    ("jacobi2d", (4096, 4096), 16, (32, 32)),
    ("jacobi2d", (9720, 1024), 16, (32, 32)),
    ("hotspot", (9720, 1024), 8, (32, 32)),
    ("sobel2d_replicate", (9720, 1024), 8, (32, 32)),
    ("heat3d_periodic", (9720, 32, 32), 4, (8, 8, 32)),
    ("jacobi2d_replicate_bucket", (10240, 1024), 16, (32, 32)),
    # the benchmark's cells: every HEAT3D block an edge block, 13.65% of
    # JACOBI2D's at s=8
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32)),
    ("heat3d", (9720, 32, 32), 1, (16, 8, 32)),
    ("jacobi2d", (9720, 1024), 8, (64, 64)),
]
MAIN = [  # chip_smoke.py's main path, 16 iterations
    ("jacobi2d", (9720, 1024)), ("jacobi2d", (4096, 4096)),
    ("hotspot", (9720, 1024)), ("blur_jacobi2d", (9720, 1024)),
    ("sobel2d_replicate", (9720, 1024)), ("heat3d_periodic", (9720, 32, 32)),
]
# JACOBI2D 4096x4096, 16 iterations through the round loop: (s, tile)
SWEEP = [(s, t) for t in ((32, 32), (64, 64)) for s in (1, 2, 4, 8, 16)]
REQUEST = (9000, 1000)   # the bucket case's request inside its bucket


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def timed(fn, inner: int) -> float:
    """Median ms of one call over 10 samples of ``inner`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / inner)
    return float(np.median(ts))


def case_spec(key, shape):
    if key != "jacobi2d_replicate_bucket":
        return lower(stencils.get(key, shape=shape, iterations=16)).spec, None
    spec = lower(stencils.get("jacobi2d", shape=REQUEST, iterations=16)).spec
    spec = dataclasses.replace(spec, boundary=Boundary("replicate"))
    return bucket_plan(spec, shape, iterations=16).mspec, spec


def main():
    rng = np.random.default_rng(0)
    specs = [case_spec(k, s) for k, s, _, _ in CASES]
    cuda_build.build_many([sp for sp, _ in specs]
                          + [lower(stencils.get(k, shape=s)).spec for k, s in MAIN])
    out = {"side": sys.argv[2]}
    for (k, shape, s, tile), (spec, request) in zip(CASES, specs):
        if request is None:
            arrays = {n: rng.standard_normal(shape).astype(np.float32)
                      for n in spec.inputs}
        else:
            plan = bucket_plan(request, shape, iterations=16)
            arrays = {n: plan.place_entry(rng.standard_normal(REQUEST)
                                          .astype(np.float32))
                      for n in request.inputs}
            arrays.update(plan.service_entry(REQUEST))
        t = ops.to_device(spec, arrays, "cuda")
        res = stencil.stencil_cuda(spec, t, s, tile)
        ms = timed(lambda: stencil.stencil_cuda(spec, t, s, tile), 10)
        name = f"{k}_{'x'.join(map(str, shape))}_s{s}"
        out[name] = ms
        out[name + "_sha"] = digest(res)
    spec = lower(stencils.jacobi2d(shape=(4096, 4096), iterations=16)).spec
    t = ops.to_device(spec, {"in_1": rng.standard_normal((4096, 4096))
                             .astype(np.float32)}, "cuda")
    for s, tile in SWEEP:
        name = f"sweep_s{s}_{tile[0]}x{tile[1]}"
        run = lambda: ops.stencil_run(spec, t, 16, s=s, tile=tile)
        out[name + "_sha"] = digest(run())
        out[name] = timed(run, 3)
    for k, shape in MAIN:
        text = dsl.format_spec(stencils.get(k, shape=shape, iterations=16))
        arrays = {n: rng.standard_normal(shape).astype(np.float32)
                  for n in stencils.get(k, shape=shape).inputs}
        design = autotune(text, device="cuda")
        run = design.runner.batched
        staged = run.stage({n: a[None] for n, a in arrays.items()})
        res = run.dispatch(staged).out
        ms = timed(lambda: run.dispatch(staged), 3)
        name = f"main_{k}_{'x'.join(map(str, shape))}"
        out[name] = ms
        out[name + "_sha"] = digest(res)
        out[name + "_config"] = [design.config.s, list(run.tile)]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
