"""Canonical metric names for the serving subsystem (the reference
package's names, kept so both packages report under one spelling), and
the spans and counters that only the port emits.

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

# ---- the port's own vocabulary (the reference package has none of it) -- #
# Host reads of device values and operations that block the host on the
# device, by call site (``obs.syncs``): the syncs a clustering call or a
# stream step makes, whether or not a collector is installed.
HOST_SYNCS = "host_syncs_total"
# Launches of the node-flag kernel (``kernels.nodeflags``): one a frontier
# node mask built on the card, where the CPU runs the reference's loop.
NODE_FLAG_LAUNCHES = "node_flag_launches_total"
# The points a ``dbscan`` call clusters, and of those the points in dense
# cells of its plan's index (0 for a plain index), by backend: counted
# beside ``dbscan_runs_total``.
DBSCAN_POINTS = "dbscan_points_total"
DBSCAN_DENSE_POINTS = "dbscan_dense_points_total"
# The distance tests of walk lanes whose point lies outside every dense
# cell, by phase and engine: the part of ``traversal_evals_total`` that no
# dense short-circuit can cut.
TRAVERSAL_LOOSE_EVALS = "traversal_loose_evals_total"

# Counters and spans only the port emits; parity tests drop them before
# comparing a run's collectors with the reference's.
PORT_COUNTERS = (HOST_SYNCS, NODE_FLAG_LAUNCHES, DBSCAN_POINTS,
                 DBSCAN_DENSE_POINTS, TRAVERSAL_LOOSE_EVALS)
# ``plan.hash``: the content hash inside ``plan``; ``build.grid`` (the
# grid or segments and the Morton sort), ``build.tree`` (the LBVH: its
# topology, box fit and ropes) and ``build.pack`` (the walk kernel's
# layout) inside ``build``; ``stream.wal`` (a log record's
# device-to-host copy, write, flush and fsync) inside the stream operation
# that logs it.
PORT_SPANS = ("plan.hash", "build.grid", "build.tree", "build.pack",
              "stream.wal")

ALL = tuple(v for k, v in sorted(globals().items())
            if k.isupper() and isinstance(v, str))
