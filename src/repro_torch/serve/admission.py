"""Admission control, backpressure, and SLO tracking (DESIGN.md §13).

The port of ``repro.serve.admission``: host code, the reference's own,
reporting to ``repro_torch.obs``.

A server that accepts unbounded work does not degrade, it collapses: the
queue grows without bound, every request's latency grows with it, and by
the time the caller notices, *all* of them are late.  The admission
controller keeps the serving plane's queues bounded and rejects the
overflow *immediately* with a typed :class:`Overloaded` error carrying
enough context (kind, queue depth, limit, a retry hint) for a client to
back off — a fast "no" instead of a slow nothing.

Three independent budgets:

  * ``max_pending_requests`` — queued query requests (head-of-line count);
  * ``max_pending_points``   — queued probe *points* (the real work unit;
    a single request is also capped at the batcher's ``max_batch`` so it
    can always be coalesced whole);
  * ``max_pending_inserts``  — queued write batches (the writer applies
    them strictly in order; bounding the queue bounds the
    acknowledged-but-unapplied window).

SLO tracking rides on the obs sketches: per (kind, tenant) request
latencies go into bounded-memory quantile histograms — both into the
process-wide registry (the ``repro.obs/v1`` snapshot schema, the
reference's) *and* into a private always-on registry, so :meth:`stats`
can report p50/p99 even when the embedding process installed no
collector.
"""
from __future__ import annotations

import threading

from repro_torch.obs import metrics as obs_metrics


class Overloaded(RuntimeError):
    """Typed load-shed rejection: the request was *not* admitted.

    kind: "query" | "insert".
    reason: which budget rejected ("requests", "points", "inserts") or
        "shutdown" when the server is draining.
    depth / limit: the queue depth that triggered the rejection and its
        configured bound (depth is in the budget's own unit).
    retry_after_s: a crude backoff hint (one batching deadline window) —
        clients that wait this long see a drained queue or a consistent
        rejection, never a hang.
    """

    def __init__(self, kind: str, reason: str, depth: int, limit: int,
                 retry_after_s: float = 0.0):
        self.kind = kind
        self.reason = reason
        self.depth = int(depth)
        self.limit = int(limit)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"{kind} rejected ({reason}): depth {depth} >= limit {limit}"
            + (f"; retry after {retry_after_s * 1e3:.0f}ms"
               if retry_after_s else ""))


class AdmissionController:
    """Bounded admission + latency SLO sketches for one server."""

    def __init__(self, *, max_pending_requests: int = 256,
                 max_pending_points: int = 65536,
                 max_pending_inserts: int = 8,
                 retry_after_s: float = 0.0):
        if min(max_pending_requests, max_pending_points,
               max_pending_inserts) < 1:
            raise ValueError("admission limits must all be >= 1")
        self.max_pending_requests = int(max_pending_requests)
        self.max_pending_points = int(max_pending_points)
        self.max_pending_inserts = int(max_pending_inserts)
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._requests = 0
        self._points = 0
        self._inserts = 0
        self._closed = False
        self._shed = {"query": 0, "insert": 0}
        self._done = {"query": 0, "insert": 0}
        self._slo = obs_metrics.Registry()   # private, always on

    # ---- admission ---------------------------------------------------- #

    def admit_query(self, n_points: int) -> None:
        """Admit one query request of ``n_points`` probes or raise
        :class:`Overloaded`; on success the request holds both budgets
        until :meth:`release_query`."""
        with self._lock:
            if self._closed:
                self._shed["query"] += 1
                raise Overloaded("query", "shutdown", self._requests,
                                 self.max_pending_requests)
            if self._requests + 1 > self.max_pending_requests:
                self._shed["query"] += 1
                obs_metrics.inc("serve_shed_total", kind="query",
                                reason="requests")
                raise Overloaded("query", "requests", self._requests,
                                 self.max_pending_requests,
                                 self.retry_after_s)
            if self._points + n_points > self.max_pending_points:
                self._shed["query"] += 1
                obs_metrics.inc("serve_shed_total", kind="query",
                                reason="points")
                raise Overloaded("query", "points", self._points,
                                 self.max_pending_points,
                                 self.retry_after_s)
            self._requests += 1
            self._points += n_points

    def release_query(self, n_points: int) -> None:
        with self._lock:
            self._requests -= 1
            self._points -= n_points

    def admit_insert(self) -> None:
        """Admit one insert batch or raise :class:`Overloaded`."""
        with self._lock:
            if self._closed:
                self._shed["insert"] += 1
                raise Overloaded("insert", "shutdown", self._inserts,
                                 self.max_pending_inserts)
            if self._inserts + 1 > self.max_pending_inserts:
                self._shed["insert"] += 1
                obs_metrics.inc("serve_shed_total", kind="insert",
                                reason="inserts")
                raise Overloaded("insert", "inserts", self._inserts,
                                 self.max_pending_inserts,
                                 self.retry_after_s)
            self._inserts += 1

    def release_insert(self) -> None:
        with self._lock:
            self._inserts -= 1

    def close(self) -> None:
        """Stop admitting (drain mode): every later admit raises
        ``Overloaded(reason="shutdown")``; already-admitted work keeps
        its budget until released."""
        with self._lock:
            self._closed = True

    # ---- SLO tracking ------------------------------------------------- #

    def observe(self, kind: str, seconds: float, *, tenant: str = "") -> None:
        """Record one completed request's latency (both registries)."""
        with self._lock:
            self._done[kind] = self._done.get(kind, 0) + 1
        self._slo.histogram("serve_request_seconds",
                            labels=("kind", "tenant")) \
            .labels(kind=kind, tenant=tenant).observe(seconds)
        obs_metrics.observe("serve_request_seconds", seconds, kind=kind,
                            tenant=tenant)

    def _quantile(self, kind: str, tenant: str, q: float) -> float:
        h = self._slo.get("serve_request_seconds", kind=kind, tenant=tenant)
        return h.quantile(q) if h is not None and h.count else float("nan")

    def stats(self, tenants: tuple[str, ...] = ("",)) -> dict:
        """Queue depths, shed counts, and p50/p99 latency per kind."""
        with self._lock:
            out = {
                "pending_requests": self._requests,
                "pending_points": self._points,
                "pending_inserts": self._inserts,
                "closed": self._closed,
                "shed": dict(self._shed),
                "completed": dict(self._done),
            }
        for kind in ("query", "insert"):
            # per-kind latency pooled across tenants: report the worst
            # tenant's quantile (an SLO is a guarantee, not an average)
            qs = [(self._quantile(kind, t, 0.5), self._quantile(kind, t, 0.99))
                  for t in tenants]
            qs = [(a, b) for a, b in qs if a == a]      # drop NaNs
            out[f"{kind}_p50_s"] = max(a for a, _ in qs) if qs else float("nan")
            out[f"{kind}_p99_s"] = max(b for _, b in qs) if qs else float("nan")
        return out
