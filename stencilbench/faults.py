"""Faults planted under the timed path, to show that the comparison
catches them: each patches the round loop the batched K2 runner calls
(``repro_torch.kernels.pipeline.stencil_run_batched``) for as long as the
context is open.  The cells run on one card, so no exchange between chips
can be left out.
"""
from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def planted(fault: str):
    """``state_unchanged``: the solve returns its input; ``half_batch``:
    the second half of the batch is left out (returned as it came in);
    ``answer_altered``: one cell of the output is raised by 1 where the
    output is produced."""
    from repro_torch.kernels import pipeline

    real = pipeline.stencil_run_batched

    def state_unchanged(spec, arrays, iterations=None, s=1, tile=None):
        return arrays[spec.iterate_input]

    def half_batch(spec, arrays, iterations=None, s=1, tile=None):
        import torch

        x = arrays[spec.iterate_input]
        h = x.shape[0] // 2
        done = real(spec, {n: a[:h] for n, a in arrays.items()},
                    iterations, s=s, tile=tile)
        return torch.cat([done, x[h:]])

    def answer_altered(spec, arrays, iterations=None, s=1, tile=None):
        out = real(spec, arrays, iterations, s=s, tile=tile)
        out.view(-1)[out.numel() // 3] += 1.0
        return out

    pipeline.stencil_run_batched = {
        "state_unchanged": state_unchanged,
        "half_batch": half_batch,
        "answer_altered": answer_altered,
    }[fault]
    try:
        yield
    finally:
        pipeline.stencil_run_batched = real
