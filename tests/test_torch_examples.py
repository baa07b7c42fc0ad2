"""The port's examples (``examples_torch/*.py``) on the CPU, in-process
through each one's ``main([..., "--device", "cpu"])``, at their own sizes
or cut (``serve_stencils --iterations 1``, ``train_lm --preset tiny
--steps 6``).  Where an example computes what no parity test covers, it
is held against the JAX package on the same seeded inputs:

  * quickstart's output against ``repro.kernels.ref.stencil_iterations_ref``
    within ``repro.core.numerics.tolerance_for``;
  * serve_stencils' counters (cache hits, micro-batches, compiled buckets,
    warm-restart rankings and store hits) equal to the JAX example's, and
    every result bitwise equal to single-shot ``serve()``;
  * serve_lm's tokens equal to the reference ``ServeEngine``'s, with the
    reference's parameters carried across by
    ``models.convert.params_from_numpy``;
  * train_lm's parameter count equal to the JAX example's.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example(name: str):
    return load(ROOT / "examples_torch" / f"{name}.py", f"_port_{name}")


def reference_example(name: str):
    return load(ROOT / "examples" / f"{name}.py", f"_ref_{name}")


def run_main(module, argv=None):
    """``module.main(argv)``'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = module.main() if argv is None else module.main(argv)
    return got, buf.getvalue()


def test_every_example_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in ("quickstart", "serve_stencils", "stencil_multidevice",
                 "train_lm", "serve_lm", "elastic_restart"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_main(example(name), [])


def test_quickstart_matches_the_reference_oracle():
    from repro.core import dsl, numerics
    from repro.core.ir import lower
    from repro.kernels import ref

    qs = example("quickstart")
    got, text = run_main(qs, ["--device", "cpu"])
    spec = lower(dsl.parse(qs.DSL)).spec
    x = np.random.default_rng(0).standard_normal((1024, 512)).astype(
        np.float32)
    want = np.asarray(ref.stencil_iterations_ref(spec, {"in_1": jnp.asarray(x)}))
    tol = numerics.tolerance_for(spec, arrays={"in_1": x})
    assert np.isfinite(tol)
    assert float(np.abs(got["out"] - want).max()) <= tol
    assert got["max_abs_err"] <= got["tolerance"]
    assert "on 8 H100s the tuner picks" in text


COUNTERS = (
    r"  cache: \d+ hits / \d+ misses \(\d+ entries\)",
    r"  \w+: \d+ grids in \d+ batches \(\+\d+ pad\)",
    r"second server register\('jacobi'\): cache_hit=\w+",
    r"served \d+ grids of \d+ distinct shapes in \d+ micro-batches from "
    r"\d+ compiled bucket designs",
    r"  bucket \d+x\d+: \d+ grids, \d+ hits / \d+ compiles",
    r"  \w+ \([^)]*\): \d+ grids, \d+ bucket design\(s\) \[[^]]*\]",
    r"registered 'jacobi' as a logical kernel \(warm bucket: .*\)",
    r"(cold replica|warm restart): first result in \d+ ms "
    r"\(autotune_calls=\d+",
    r"store_hits=\d+",
)


def counters(text: str) -> list[str]:
    """The counter lines of a serve_stencils run, timings dropped: what
    the reference's and the port's servers must agree on."""
    got = []
    for line in text.splitlines():
        for pattern in COUNTERS:
            m = re.search(pattern, line)
            if m:
                got.append(re.sub(r"first result in \d+ ms", "", m.group(0)))
    return got


def test_serve_stencils_counters_match_the_reference():
    got, text = run_main(example("serve_stencils"),
                         ["--device", "cpu", "--iterations", "1"])
    assert all(part["bitwise"] for part in got.values())
    assert got["exact"]["second_cache_hit"]
    assert got["warm_restart"]["warm_autotune_calls"] == 0
    _, want = run_main(reference_example("serve_stencils"))
    assert counters(text) == counters(want)
    assert len(counters(want)) == 14


def test_stencil_multidevice_runs_every_config_correctly():
    got, text = run_main(example("stencil_multidevice"), ["--device", "cpu"])
    assert [v for v, _ in got["results"]] == [
        "spatial_s", "hybrid_s", "hybrid_r", "temporal"]
    assert all(ok for _, ok in got["results"]), text
    assert "devices: 8" in text


def test_train_lm_tiny_trains_and_counts_the_references_parameters(tmp_path):
    from repro.models.model_zoo import build_model as ref_build_model

    tl = example("train_lm")
    got, text = run_main(tl, ["--preset", "tiny", "--steps", "6",
                              "--device", "cpu", "--ckpt-dir",
                              str(tmp_path)])
    assert len(got["losses"]) == 6 and np.all(np.isfinite(got["losses"]))
    assert "final loss" in text and any(tmp_path.iterdir())
    cfg, _, _ = reference_example("train_lm").make_cfg("tiny")
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    assert got["params"] == sum(int(x.size) for x in jax.tree.leaves(shapes))


def test_serve_lm_tokens_match_the_reference_engine():
    from repro.configs import base as ref_base
    from repro.models.model_zoo import build_model as ref_build_model
    from repro.serve.lm import Request as RefRequest
    from repro.serve.lm import ServeEngine as RefServeEngine

    from repro_torch.configs import base
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model_zoo import build_model

    sl = example("serve_lm")
    got, text = run_main(sl, ["--device", "cpu"])
    assert got["generated"] == 96 and "warm:" in text

    ref_cfg = ref_base.get("recurrentgemma_2b").reduced()
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = base.get("recurrentgemma_2b").reduced()
    reqs = sl.requests_for(cfg)
    want = RefServeEngine(ref_model, ref_params, batch_size=4,
                          cache_len=96).generate(
        [RefRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
         for r in reqs])
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    out = sl.engine_for(build_model(cfg, device="cpu"), params).generate(reqs)
    assert len(out) == len(want)
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_elastic_restart_resumes_and_restores_bitwise():
    got, text = run_main(example("elastic_restart"), ["--device", "cpu"])
    assert got["identical"] and got["step"] == 20
    assert "injected failure at step 12" in text
    assert "resumed from step 10" in text
