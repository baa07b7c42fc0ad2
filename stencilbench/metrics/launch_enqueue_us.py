"""Mean host microseconds of one tile-kernel launch call in the traced
window (``cudaFuncSetAttribute`` and the launch itself): the
``sasa.launch.enqueue`` spans of ``repro_torch.trace``.  Nothing where the
port has no such span or no kernel was launched (the plain versions)."""


def read(rec):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    count, seconds = trace.totals().get("sasa.launch.enqueue", (0, 0.0))
    return seconds / count * 1e6 if count else None
