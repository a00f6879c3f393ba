"""Observability layer: metrics + tracing + the ``torch.profiler`` shim,
zero dependencies beyond PyTorch, disabled by default.

  * :mod:`repro_torch.obs.metrics` — named counters, gauges, and
    bounded-memory quantile histograms with labeled families and a stable
    JSON snapshot schema (``metrics.SCHEMA``, the reference package's).
  * :mod:`repro_torch.obs.trace` — nestable phase spans with CUDA-sync
    aware timing, exported as Chrome trace-event JSON (loads in Perfetto /
    ``chrome://tracing``) with the offset that puts them on
    ``torch.profiler``'s clock (``otherData["clock_offset_us"]``).
  * :mod:`repro_torch.obs.syncs` — the host syncs the program makes,
    counted by call site (``host_syncs_total``).
  * :mod:`repro_torch.obs.names` — metric names shared with the reference
    package, and the spans and counters only the port emits.
  * :func:`instrumented` — install both for a scoped block and restore
    the previous collectors afterwards (what the tests and the smoke run
    use).

Until a collector is installed every instrumentation point in the library
is a module-global load + ``None`` check: no device sync, no host read of
a device value, and results are byte-equal either way. An installed
registry adds no sync either: a counter given a device tensor keeps a
pending sum on the device and reads it once, at ``snapshot()``/``get()``.

Annotation rule: each span enters ``torch.profiler.record_function(name)``
while a profiler capture is live — a span of an installed tracer made
with ``annotate=True``, and every span when no tracer is installed — so a
capture names the program's phases; with no capture live and no tracer,
a span is the shared no-op.

    from repro_torch.obs import metrics, trace
    reg = metrics.install()
    tr = trace.install(sync=True)
    ... run dbscan / neighbor queries ...
    reg.write_json("metrics.json")
    tr.export("trace.json")          # open in chrome://tracing
"""
from __future__ import annotations

from contextlib import contextmanager

from . import metrics, names, syncs, trace

__all__ = ["metrics", "names", "syncs", "trace", "instrumented"]


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
