"""Time bucketed serving (``chip_smoke.py``'s phase ``serve`` traffic)
from one source tree; prints one JSON line per boundary mode with the
runner's path, the tile kernels' launches a flush, the median grids/s and
a sha256 digest of the results.

Compares the serving path of two commits on one card.  Unpack the other
commit's package with ``git archive <commit> src/repro_torch | tar -x -C
build/parent`` (``build/`` is gitignored), then, in one call on the card,
alternate the two sides so drift on the machine falls on both::

    for side in P C C P P C C P; do
      if [ $side = P ]; then python3 tools/serve_ab.py build/parent/src parent
      else python3 tools/serve_ab.py src change; fi
    done

Each process builds its tree's kernels (into that tree's own ``build/``)
and serves the 40 requests of phase ``serve`` (JACOBI2D, 16 iterations,
4 boundary modes x 5 shapes x 2 requests, seed 2022, the (10240,) x
(1024, 1088) bucket ladder, ``max_batch=4``) once to build and warm, then
``FLUSHES`` more times, each ``serve()`` of one mode's 10 requests timed
on the host clock to its last result.  Equal digests on both sides mean
bitwise equal results.
"""
import hashlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, sys.argv[1])
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (the phase's constants; imports no package)
from repro_torch.core import dsl  # noqa: E402
from repro_torch.kernels import cuda_build, pipeline, stencil  # noqa: E402
from repro_torch.runtime import DesignCache, ShapeBucketer  # noqa: E402
from repro_torch.serve import StencilRequest, StencilServer  # noqa: E402

FLUSHES = 3


def main(label: str) -> int:
    it = chip_smoke.ITERATIONS
    srv = StencilServer(device="cuda", max_batch=4, cache=DesignCache(),
                        bucketing=ShapeBucketer(ladder=chip_smoke.SERVE_LADDER),
                        async_dispatch=True, warmup=False)
    srng = np.random.default_rng(2022)
    paper = (9720, 1024)
    traffic = {}
    for mode in chip_smoke.SERVE_MODES:
        shapes = [paper] + [
            (int(srng.integers(8000, 9721)), int(srng.integers(768, 1025)))
            for _ in range(chip_smoke.SERVE_SHAPES - 1)
        ]
        spec = dsl.parse(chip_smoke.BOUNDARY_DSL.format(
            tag=mode.split()[0].upper(), it=it, boundary=mode,
            r=paper[0], c=paper[1]))
        reg = srv.register(mode.split()[0], spec)
        traffic[mode] = [
            StencilRequest(mode.split()[0],
                           {"in_1": srng.standard_normal(shape).astype(np.float32)})
            for shape in shapes for _ in range(chip_smoke.SERVE_REPEATS)
        ]
        for shape in shapes:
            reg.cached.runner_for(shape, count=0)
    cuda_build.build_many([
        e.cached.design.spec for m in chip_smoke.SERVE_MODES
        for e in srv.design(m.split()[0]).cached.buckets.values()])
    for mode in chip_smoke.SERVE_MODES:      # build and warm every path
        srv.serve(traffic[mode])
    torch.cuda.synchronize()
    for mode in chip_smoke.SERVE_MODES:
        reqs = traffic[mode]
        gps, launches = [], None
        for _ in range(FLUSHES):
            stencil.stencil_cuda.launches = 0
            pipeline.stencil_cuda_batched.launches = 0
            t0 = time.perf_counter()
            outs = srv.serve(reqs)
            gps.append(len(reqs) / (time.perf_counter() - t0))
            launches = {"K1": stencil.stencil_cuda.launches,
                        "K2": pipeline.stencil_cuda_batched.launches}
        h = hashlib.sha256()
        for o in outs:
            h.update(np.ascontiguousarray(o).tobytes())
        entry = srv.design(mode.split()[0]).cached.runner_for(
            paper, count=0)
        print(json.dumps(dict(
            side=label, mode=mode, path=entry.runner.path,
            config=dict(s=entry.config.s, tile_rows=entry.config.tile_rows,
                        buffer_depth=entry.config.buffer_depth),
            launches_per_flush=launches, requests=len(reqs),
            grids_per_s=gps, median_grids_per_s=float(np.median(gps)),
            digest=h.hexdigest()[:16])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[2]))
