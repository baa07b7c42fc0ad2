"""The port's benchmarks (``benchmarks_torch/``) against the reference's
(``benchmarks/``) on the CPU.  Timing-free: these tests run beside others
under ``xdist``, so they hold the data the gates read, never a time.

  * the serving traces (mixed geometry, mixed boundary, the Poisson
    latency trace) are the reference's: the same shapes, arrival times
    and arrays from the same seeds, routed to the same bucket counts;
  * the IR section reduces ops on the same kernels to the same counts;
  * the FPGA rows of Figs. 1, Table 3 and Sec. 5.4 equal the reference's
    row for row, and Fig. 9's feature vectors equal the reference's;
  * every smoke section's correctness gates hold on the CPU (timing gates
    are read, not held here), and the cold-start pair runs in two child
    processes with a warm side that ranks and compiles nothing.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import best_config as ref_best_config          # noqa: E402
from benchmarks import intensity as ref_intensity              # noqa: E402
from benchmarks import model_accuracy as ref_model_accuracy    # noqa: E402
from benchmarks import serving_latency as ref_serving_latency  # noqa: E402
from benchmarks import serving_throughput as ref_serving       # noqa: E402
from benchmarks import speedup_vs_soda as ref_speedup          # noqa: E402
from repro.configs import stencils as ref_stencils             # noqa: E402
from repro.runtime import DesignCache as RefDesignCache         # noqa: E402
from repro.serve import StencilServer as RefStencilServer       # noqa: E402

from benchmarks_torch import (                                  # noqa: E402
    best_config,
    cold_start,
    intensity,
    model_accuracy,
    serving_latency,
    serving_throughput,
    speedup_vs_soda,
)
from benchmarks_torch.common import Gates                       # noqa: E402
from repro_torch.configs import stencils                        # noqa: E402
from repro_torch.runtime import DesignCache                     # noqa: E402
from repro_torch.serve import StencilServer                     # noqa: E402

CPU = "cpu"
CPU_DEVICE = torch.device("cpu")


def _bucket_count(server, name, spec, shapes):
    reg = server.register(name, spec)
    return len({reg.cached.bucket_for(s) for s in shapes})


@pytest.mark.parametrize("smoke", [True, False])
def test_mixed_geometry_trace_and_buckets_match_reference(smoke):
    lo, hi = ((20, 12), (60, 30)) if smoke else ((100, 70), (250, 120))
    iters = 4 if smoke else 8
    want = ref_serving._mixed_shapes(np.random.default_rng(1), 20, lo, hi)
    got = serving_throughput._mixed_shapes(np.random.default_rng(1), 20, lo, hi)
    assert got == want and len(set(got)) == 20
    dsl = serving_throughput.MIXED_DSL.format(it=iters, r=got[0][0],
                                              c=got[0][1])
    assert dsl == ref_serving.MIXED_DSL.format(it=iters, r=want[0][0],
                                               c=want[0][1])
    from repro.core.dsl import parse as ref_parse
    from repro_torch.core.dsl import parse

    ref_n = _bucket_count(RefStencilServer(cache=RefDesignCache(),
                                           bucketing=True, warmup=False),
                          "j", ref_parse(dsl), want)
    n = _bucket_count(StencilServer(device=CPU, cache=DesignCache(),
                                    bucketing=True, warmup=False),
                      "j", parse(dsl), got)
    assert n == ref_n and n <= 4


@pytest.mark.parametrize("smoke", [True, False])
def test_mixed_boundary_trace_and_buckets_match_reference(smoke):
    iters, per_mode, shapes_by_mode, traffic = \
        serving_throughput.mixed_boundary_trace(smoke)
    lo, hi = ((18, 12), (48, 28)) if smoke else ((80, 60), (200, 100))
    rng = np.random.default_rng(2)
    from repro.core.dsl import parse as ref_parse

    ref_srv = RefStencilServer(cache=RefDesignCache(), bucketing=True,
                               warmup=False)
    srv = StencilServer(device=CPU, cache=DesignCache(), bucketing=True,
                        warmup=False)
    for mode in serving_throughput.MODES:
        want = ref_serving._mixed_shapes(rng, per_mode, lo, hi)
        assert shapes_by_mode[mode] == want
        for s in want:          # the reference draws each grid in turn
            np.testing.assert_array_equal(
                traffic[(mode, s)]["in_1"],
                rng.standard_normal(s).astype(np.float32))
        spec = serving_throughput.boundary_spec(mode, want[0], iters)
        ref_spec = ref_parse(ref_serving.BOUNDARY_DSL.format(
            tag=mode.split()[0].upper(), it=iters, boundary=mode,
            r=want[0][0], c=want[0][1]))
        name = mode.split()[0]
        assert _bucket_count(srv, name, spec, want) == _bucket_count(
            ref_srv, name, ref_spec, want)


def test_ir_section_matches_reference():
    ref_rows, rows = [], []
    ref_serving.run_ir_optimizer(ref_rows, check=True)
    serving_throughput.run_ir_optimizer(rows, Gates())
    # the kernels reduced and their counts; the tuned HEAT3D ops per cell
    assert rows[0] == ref_rows[0]
    assert rows[1].split(",")[1] == ref_rows[1].split(",")[1]


@pytest.mark.parametrize("smoke", [True, False])
def test_latency_trace_matches_reference(smoke):
    ref_designs, ref_trace = ref_serving_latency.build_trace(
        smoke, np.random.default_rng(42))
    designs, trace = serving_latency.build_trace(
        smoke, np.random.default_rng(42))
    assert sorted(designs) == sorted(ref_designs)
    for name in designs:
        assert designs[name].shape == ref_designs[name].shape
        assert designs[name].iterations == ref_designs[name].iterations
    assert len(trace) == len(ref_trace)
    for (t, req), (ref_t, ref_req) in zip(trace, ref_trace):
        assert t == ref_t and req.design == ref_req.design
        assert req.arrays.keys() == ref_req.arrays.keys()
        for k in req.arrays:
            np.testing.assert_array_equal(req.arrays[k], ref_req.arrays[k])


def test_intensity_rows_equal_reference():
    assert intensity.run(device=CPU) == ref_intensity.run()


def test_table3_fpga_rows_equal_reference():
    want = [r for r in ref_best_config.run()
            if r.startswith(("table3/fpga/", "table3/summary"))]
    rows = best_config.run(device=CPU)
    got = [r for r in rows if r.startswith(("table3/fpga/", "table3/summary"))]
    assert got == want and len(got) == 17
    # each FPGA row has its one-card and four-card H100 rows beside it
    assert sum(r.startswith("table3/h100x1/") for r in rows) == 16
    assert sum(r.startswith("table3/h100x4/") for r in rows) == 16
    assert not any("measured" in r for r in rows)   # no card, no timing


def test_speedup_fpga_rows_equal_reference():
    want = [r for r in ref_speedup.run() if "fpga_u280" in r]
    got = [r for r in speedup_vs_soda.run(device=CPU) if "fpga_u280" in r]
    assert got == want and len(got) == 9


@pytest.mark.parametrize("smoke", [True, False])
def test_model_accuracy_features_equal_reference(smoke):
    from repro_torch.core.dsl import parse

    from repro.core.dsl import format_spec

    names = model_accuracy.CALIBRATE_ON + model_accuracy.VALIDATE_ON
    assert names == ref_model_accuracy.CALIBRATE_ON + \
        ref_model_accuracy.VALIDATE_ON
    for name in names:
        for iters, s in model_accuracy.POINTS:
            spec = model_accuracy.measure_spec(name, iters, smoke)
            shape = ((64, 16, 16) if smoke else (256, 32, 32)) \
                if name in ref_stencils.BENCHMARKS_3D else \
                ((512, 128) if smoke else ref_model_accuracy.SHAPE)
            ref_spec = ref_stencils.get(name, shape=shape, iterations=iters)
            assert spec.shape == ref_spec.shape
            assert parse(format_spec(ref_spec)).ops_per_cell == spec.ops_per_cell
            np.testing.assert_array_equal(
                model_accuracy._features(spec, iters, s),
                ref_model_accuracy._features(ref_spec, iters, s))


def _smoke_serving(section):
    gates, rows = Gates(), []
    fn = getattr(serving_throughput, section)
    if section == "run_ir_optimizer":
        fn(rows, gates)
    elif section == "run_single_geometry":
        fn(rows, gates, serving_throughput.resolve_device(CPU))
    else:
        fn(rows, gates, serving_throughput.resolve_device(CPU), True)
    return gates


@pytest.mark.parametrize("section", [
    "run_ir_optimizer", "run_tile_pipeline", "run_single_geometry",
    "run_mixed_geometry", "run_mixed_boundary"])
def test_serving_smoke_sections_hold_their_correctness_gates(section):
    gates = _smoke_serving(section)
    hard = [g for g in gates if g.kind == "correctness"]
    assert hard and all(g.held for g in hard)
    if section == "run_tile_pipeline":
        calls = {g.gate.split("/")[1]: g.reading for g in hard}
        # 2 rounds: K2 once a round, K1 once per entry (4) a round
        assert calls["k2_kernel_calls"] == 2 and calls["k1_kernel_calls"] == 8


@pytest.mark.parametrize("module", [model_accuracy, serving_latency],
                         ids=["model_accuracy", "serving_latency"])
def test_smoke_scripts_hold_their_correctness_gates(module):
    gates = Gates()
    rows = module.run(smoke=True, device=CPU, gates=gates)
    hard = [g for g in gates if g.kind == "correctness"]
    assert rows and hard and all(g.held for g in hard)
    assert any(g.kind == "timing" for g in gates)


def test_cold_start_pair_warm_side_ranks_and_compiles_nothing():
    gates = Gates()
    rows = cold_start.run(device=CPU, gates=gates)
    read = {g.gate: g for g in gates}
    assert read["cold_start/bitwise"].held
    assert read["cold_start/cold_autotune_calls"].reading == 1
    for key in ("warm_autotune_calls", "warm_jit_builds",
                "warm_nvcc_compiles"):
        assert read[f"cold_start/{key}"].reading == 0
    assert read["cold_start/warm_store_hits"].reading >= 1
    assert read["cold_start/finite"].held
    assert any(r.startswith("coldstart/speedup,") for r in rows)


def test_cold_start_pair_serves_the_dsl_it_is_given():
    dsl = cold_start.DSL.replace("(256, 128)", "(24, 16)").replace(
        "iteration: 32", "iteration: 3")
    gates = Gates()
    pair = cold_start.run_cold_start([], gates, CPU_DEVICE, dsl=dsl)
    assert pair["bitwise"] and all(g.held for g in gates
                                   if g.kind == "correctness")
    for side in ("cold", "warm"):
        got = pair[side]
        assert got["finite"] and got["launches"] == 0
        assert got["first_result_s"] >= got["register_s"] > 0
    assert pair["warm"]["store_hits"] >= 1


def test_run_harness_skips_the_modules_it_is_told_to(capsys):
    from benchmarks_torch import run as harness

    skip = ("intensity,single_pe,best_config,speedup_vs_soda,"
            "serving_throughput,model_accuracy,parallelism_sweep")
    assert harness.main(["--device", "cpu", "--skip", skip]) == 0
    names = {line.split(",")[0].split("/")[0]
             for line in capsys.readouterr().out.splitlines()[1:]}
    assert "lm_roofline" in names and not names & set(skip.split(","))
    with pytest.raises(SystemExit):
        harness.main(["--device", "cpu", "--skip", "no_such_module"])


def test_scripts_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module in (serving_throughput, model_accuracy, serving_latency,
                   cold_start):
        with pytest.raises(RuntimeError, match="CUDA"):
            module.run(smoke=True)
    assert stencils.BENCHMARKS.keys() == ref_stencils.BENCHMARKS.keys()
