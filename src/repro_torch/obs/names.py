"""Canonical metric names for the serving subsystem (the reference
package's names, kept so both packages report under one spelling).

One place to spell them, so the server, the CLI, the benchmarks, and the
dashboards cannot drift apart.  All names follow the registry's
conventions (``*_total`` counters, ``*_seconds`` latency histograms,
bare nouns for gauges) and export cleanly in the ``repro.obs/v1``
snapshot schema.

Label sets (by convention; the registry enforces per-family consistency):

  * ``SERVE_REQUESTS`` / ``SERVE_REQUEST_SECONDS`` — ``kind``
    ("query" | "insert"), ``tenant``;
  * ``SERVE_SHED`` — ``kind``, ``reason`` ("requests" | "points" |
    "inserts");
  * ``SERVE_FLUSHES`` — ``reason`` ("full" | "deadline" | "drain");
  * ``SERVE_SNAPSHOT_PUBLISHES`` / ``SERVE_SNAPSHOT_VERSION`` /
    ``SERVE_TENANT_ACTIVE_POINTS`` — ``tenant`` (emitted by
    ``TenantView.publish``, the one publisher that knows the tenant; a
    bare ``SnapshotStore`` emits nothing).
"""
from __future__ import annotations

# ---- request plane ---------------------------------------------------- #
SERVE_REQUESTS = "serve_requests_total"
SERVE_REQUEST_SECONDS = "serve_request_seconds"
SERVE_SHED = "serve_shed_total"
SERVE_FLUSHES = "serve_flushes_total"
SERVE_BATCH_PROBES = "serve_batch_probes"
SERVE_QUEUE_DEPTH = "serve_queue_depth"             # gauge; kind label

# ---- snapshot plane --------------------------------------------------- #
SERVE_SNAPSHOT_PUBLISHES = "serve_snapshot_publishes_total"
SERVE_SNAPSHOT_VERSION = "serve_snapshot_version"   # gauge
SERVE_SNAPSHOT_QUERIES = "serve_snapshot_queries_total"
SERVE_SNAPSHOT_EXACT_PROBES = "serve_snapshot_exact_probes_total"
SERVE_APPLY_FAILURES = "serve_apply_failures_total"
SERVE_TENANT_ACTIVE_POINTS = "serve_tenant_active_points"   # gauge

# ---- streaming handle (recompile accounting) --------------------------- #
# Incremented once per *new* (mode, level shape, probe bucket) program
# signature seen by StreamingDBSCAN's query path; flat at steady state —
# the witness that probe-batch padding keeps the jit cache warm.
STREAM_QUERY_RECOMPILES = "stream_query_recompiles_total"

ALL = tuple(v for k, v in sorted(globals().items())
            if k.isupper() and isinstance(v, str))
