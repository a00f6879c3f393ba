"""Observability layer: metrics + tracing + the ``torch.profiler`` shim,
zero dependencies beyond PyTorch, disabled by default.

  * :mod:`repro_torch.obs.metrics` — named counters, gauges, and
    bounded-memory quantile histograms with labeled families and a stable
    JSON snapshot schema (``metrics.SCHEMA``, the reference package's).
  * :mod:`repro_torch.obs.trace` — nestable phase spans with CUDA-sync
    aware timing, exported as Chrome trace-event JSON (loads in Perfetto /
    ``chrome://tracing``), plus a ``torch.profiler.record_function`` shim.
  * :func:`instrumented` — install both for a scoped block and restore
    the previous collectors afterwards (what the tests and the smoke run
    use).

Until a collector is installed every instrumentation point in the library
is a module-global load + ``None`` check: no device sync, no host read of
a device value, and results are byte-equal either way.

    from repro_torch.obs import metrics, trace
    reg = metrics.install()
    tr = trace.install(sync=True)
    ... run dbscan / neighbor queries ...
    reg.write_json("metrics.json")
    tr.export("trace.json")          # open in chrome://tracing
"""
from __future__ import annotations

from contextlib import contextmanager

from . import metrics, trace

__all__ = ["metrics", "trace", "instrumented"]


@contextmanager
def instrumented(*, sync: bool = True, annotate: bool = True):
    """Install a fresh registry + tracer for the enclosed block, yielding
    ``(registry, tracer)``; the previously installed collectors (possibly
    None) are restored on exit."""
    prev_reg, prev_tr = metrics.active(), trace.active()
    reg = metrics.install()
    tr = trace.install(sync=sync, annotate=annotate)
    try:
        yield reg, tr
    finally:
        metrics.install(prev_reg) if prev_reg is not None \
            else metrics.uninstall()
        trace.install(prev_tr) if prev_tr is not None else trace.uninstall()
