"""Request-facing stencil serving of the PyTorch port: the server, the
continuous-batching scheduler and the replicated router.

The names load on first use, so ``python -m repro_torch.serve --worker``
can claim its protocol stream before torch is imported.
"""
import importlib

_EXPORTS = {
    "Backpressure": "scheduler",
    "StencilRequest": "engine",
    "StencilRouter": "router",
    "StencilScheduler": "scheduler",
    "StencilServer": "engine",
    "Ticket": "scheduler",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
