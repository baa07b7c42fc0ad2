"""stencilbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell once::

    python3 stencilbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations and metrics are named in ``BENCHMARK.json`` at the
root of the checkout and found by name under this folder:

* ``configs/<config>.py``: one stencil configuration (its DSL text, grid,
  dtype, the work of one cell update and its plain reference);
* ``traffic/<mix>.json``: one traffic mix (grids and iterations per solve,
  the loop, the input pool);
* ``metrics/<metric>.py``: one per-layer metric, a ``read(records)`` that
  returns a number or ``None``;
* ``limits/<cell>.json``: the limit of each number that decides ``correct``,
  with the readings it was set from.

Nothing here imports ``jax`` or the JAX package; the yardstick (traffic,
work counts, peaks, trace reduction, references, the comparison) lives
here so that changes to the program cannot move it.
"""
