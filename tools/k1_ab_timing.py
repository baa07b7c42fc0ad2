"""Time K1 (stencil_cuda) from one source tree; prints one JSON line.

Compares the tile kernel of two commits on one card.  Unpack the other
commit with ``git archive <commit> | tar -x -C build/parent`` (``build/``
is gitignored), then, in one call on the card, alternate the two sides so
drift on the machine falls on both::

    for side in P C C P P C C P; do
      if [ $side = P ]; then python3 tools/k1_ab_timing.py build/parent/src parent
      else python3 tools/k1_ab_timing.py src change; fi
    done

Each process builds its tree's kernels (into that tree's own ``build/``),
then takes the median of 20 launches, between CUDA events, of one round
per case below.
"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from repro_torch.configs import stencils
from repro_torch.core.ir import lower
from repro_torch.kernels import cuda_build, ops, stencil
cases = [("jacobi2d", (4096, 4096), 1), ("jacobi2d", (9720, 1024), 16),
         ("hotspot", (9720, 1024), 8), ("sobel2d_replicate", (9720, 1024), 8)]
specs = [lower(stencils.get(k, shape=s, iterations=16)).spec for k, s, _ in cases]
cuda_build.build_many(specs)
rng = np.random.default_rng(0)
out = {"side": sys.argv[2]}
for (k, shape, s), spec in zip(cases, specs):
    t = ops.to_device(spec, {n: rng.standard_normal(shape).astype(np.float32) for n in spec.inputs}, "cuda")
    for _ in range(3):
        stencil.stencil_cuda(spec, t, s)
    torch.cuda.synchronize()
    ts = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        a.record(); stencil.stencil_cuda(spec, t, s); b.record(); b.synchronize()
        ts.append(a.elapsed_time(b))
    out[f"{k}_{shape[0]}x{shape[1]}_s{s}"] = float(np.median(ts))
print(json.dumps(out), flush=True)
