"""The serving subsystem's front door (DESIGN.md §13).

The port of ``repro.serve.server``: the reference's two threads and
contracts, with every tenant's handle and snapshots on one device (the
current CUDA device unless the caller passes ``device="cpu"``).

``Server`` turns one shared point stream plus N tenant ``(eps, min_pts)``
views into a long-lived service with two decoupled planes:

  * the **query plane** — requests are admitted (bounded queues, typed
    ``Overloaded`` shedding), coalesced by per-tenant adaptive
    micro-batchers, and executed by the query worker against each
    tenant's *published* :class:`~repro_torch.serve.snapshot.IndexSnapshot`.
    Snapshots are immutable and swapped atomically, so a query batch is
    never blocked by — and can never observe a torn state from — a
    concurrent insert, merge, or compaction;
  * the **write plane** — a single writer thread applies admitted insert
    batches to every tenant's streaming handle in order (each handle's
    WAL/checkpoint durability applies unchanged), then freezes and
    publishes each tenant's next snapshot version off-path.  An insert
    is acknowledged (its future resolves) only after every tenant has
    applied *and republished*, so an acknowledged write is visible to
    the very next admitted query.

Requests are asynchronous: ``submit_query`` / ``submit_insert`` return
``concurrent.futures.Future`` objects; ``query`` / ``insert`` are the
blocking conveniences.  Invalid input (NaN/Inf, wrong dimensionality,
oversized requests) fails synchronously with ``ValueError`` at submit
time — malformed data is the client's fault and must never consume
write-plane budget.

Graceful shutdown (:meth:`shutdown`, also wired to SIGTERM /
KeyboardInterrupt by the CLI): admission closes (new work sheds with
``Overloaded(reason="shutdown")``), both planes drain everything already
admitted, every tenant writes a final checkpoint through the durability
path, and the process can exit 0 with nothing acknowledged-but-unapplied
left behind.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np

import torch

from repro_torch.core import dispatch
from repro_torch.core.validate import check_points
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import names as obs_names
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import admission as admission_mod
from repro_torch.serve import batching, tenants as tenants_mod
from repro_torch.serve.admission import Overloaded

__all__ = ["Server", "ServerConfig", "QueryReply", "InsertReply",
           "Overloaded"]


class ServerConfig(NamedTuple):
    """Serving-plane knobs (see DESIGN.md §13 for the policy rationale).

    max_batch: probe points per coalesced flush (also the per-request
        size cap — a request is never split across flushes).
    max_delay_s: batching deadline — the longest a pending query may wait
        for co-travelers.
    adaptive: shrink the flush target under light load (see
        ``serve.batching.MicroBatcher``).
    max_pending_requests / max_pending_points / max_pending_inserts:
        admission budgets; overflow sheds with :class:`Overloaded`.
    publish_every: publish new tenant snapshots after every K applied
        insert batches (1 = every insert is immediately visible;
        higher trades freshness for writer throughput).
    drain_timeout_s: how long :meth:`shutdown` waits for the planes to
        drain before giving up (the threads are daemonic — a stuck drain
        cannot hang process exit).
    """
    max_batch: int = 1024
    max_delay_s: float = 0.002
    adaptive: bool = True
    max_pending_requests: int = 256
    max_pending_points: int = 65536
    max_pending_inserts: int = 8
    publish_every: int = 1
    drain_timeout_s: float = 30.0


class QueryReply(NamedTuple):
    """One query request's result, tagged with its consistency point."""
    labels: np.ndarray
    counts: np.ndarray
    would_be_core: np.ndarray
    version: int            # snapshot version the batch executed against
    tenant: str


class InsertReply(NamedTuple):
    """One acknowledged insert batch: durable and visible everywhere."""
    watermark: int                  # stream length after the batch
    versions: dict                  # tenant -> published snapshot version


class _InsertReq(NamedTuple):
    pts: np.ndarray
    future: Future
    arrived_at: float


class Server:
    """A multi-tenant streaming-DBSCAN server over one point stream.

    points: initial point set, bootstrap-clustered per tenant over one
        shared index build (ignored when recovering via :meth:`restore`).
    tenants: iterable of ``(name, eps, min_pts)`` (or
        :class:`~repro_torch.serve.tenants.TenantSpec`).
    config: :class:`ServerConfig`.
    durability_dir: per-tenant WAL + checkpoint files live here
        (``<name>.wal`` / ``<name>.npz``); None disables durability.
    window / checkpoint_every / handle kwargs: forwarded to every
        tenant's ``StreamingDBSCAN``.
    keep_versions: snapshot history retained per tenant (>=1; the
        linearizability tests use a deeper history).
    device: where every handle and snapshot lives and every query runs;
        default the current CUDA device (``RuntimeError`` without one —
        pass ``device="cpu"`` for the plain versions on the host).

    On the card the query thread issues its work on a CUDA stream of its
    own. The writer's insert is a host-driven chain of thousands of
    launches on its stream; on one shared stream a query flush would queue
    behind all of it, and the reference's contract that queries are never
    blocked behind inserts would break.
    """

    def __init__(self, points, tenants, *, config: ServerConfig | None = None,
                 durability_dir: str | None = None,
                 window: int | None = None, checkpoint_every: int = 0,
                 keep_versions: int = 1, device=None, _views=None,
                 **handle_kwargs):
        self.config = config or ServerConfig()
        if self.config.max_batch < 1 or self.config.publish_every < 1:
            raise ValueError("max_batch and publish_every must be >= 1")
        self.device = dispatch.resolve_device(device)
        self._durability_dir = durability_dir
        with obs_trace.span("serve.bootstrap"):
            if _views is not None:
                self._views = _views
            else:
                self._views = tenants_mod.build_views(
                    points, tenants, durability_dir=durability_dir,
                    window=window, checkpoint_every=checkpoint_every,
                    keep_versions=keep_versions, device=self.device,
                    **handle_kwargs)
        self._by_name = {v.name: v for v in self._views}
        self.admission = admission_mod.AdmissionController(
            max_pending_requests=self.config.max_pending_requests,
            max_pending_points=self.config.max_pending_points,
            max_pending_inserts=self.config.max_pending_inserts,
            retry_after_s=self.config.max_delay_s)
        self._batchers = {
            v.name: batching.MicroBatcher(
                max_batch=self.config.max_batch,
                max_delay_s=self.config.max_delay_s,
                adaptive=self.config.adaptive)
            for v in self._views}
        self._qcond = threading.Condition()
        self._wcond = threading.Condition()
        self._inserts: list[_InsertReq] = []
        self._unpublished = 0           # applied batches since last publish
        self._draining = False
        self._stopped = False
        self._apply_failures = 0
        self._qstream = (torch.cuda.Stream(self.device)
                         if self.device.type == "cuda" else None)
        self._qthread = threading.Thread(target=self._query_loop,
                                         name="serve-query", daemon=True)
        self._wthread = threading.Thread(target=self._write_loop,
                                         name="serve-writer", daemon=True)
        self._qthread.start()
        self._wthread.start()

    # ------------------------------------------------------------------ #
    # construction / recovery                                            #
    # ------------------------------------------------------------------ #

    @classmethod
    def restore(cls, tenants, *, durability_dir: str,
                config: ServerConfig | None = None,
                window: int | None = None, checkpoint_every: int = 0,
                keep_versions: int = 1, device=None,
                **handle_kwargs) -> "Server":
        """Recover a server from its per-tenant durability files.

        Every tenant recovers independently (checkpoint + WAL replay);
        lagging replicas are topped up from the leader's point stream
        (see :func:`repro_torch.serve.tenants.restore_views`), so serving
        resumes with all tenants at one watermark and fresh snapshots, on
        ``device`` (default the current CUDA device).
        """
        device = dispatch.resolve_device(device)
        with obs_trace.span("serve.restore"):
            views = tenants_mod.restore_views(
                tenants, durability_dir=durability_dir, window=window,
                checkpoint_every=checkpoint_every,
                keep_versions=keep_versions, device=device, **handle_kwargs)
        return cls(None, tenants, config=config,
                   durability_dir=durability_dir, device=device,
                   _views=views)

    # ------------------------------------------------------------------ #
    # public request surface                                             #
    # ------------------------------------------------------------------ #

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(v.name for v in self._views)

    def _view(self, tenant: str | None) -> tenants_mod.TenantView:
        if tenant is None:
            if len(self._views) == 1:
                return self._views[0]
            raise ValueError(f"server has {len(self._views)} tenants "
                             f"{self.tenants}; pass tenant=")
        v = self._by_name.get(tenant)
        if v is None:
            raise ValueError(f"unknown tenant {tenant!r}; have "
                             f"{self.tenants}")
        return v

    def submit_query(self, pts, *, tenant: str | None = None) -> Future:
        """Admit one query request; resolves to a :class:`QueryReply`.

        Raises ValueError synchronously for malformed probes (NaN/Inf,
        wrong d, more than ``config.max_batch`` points) and
        :class:`Overloaded` when admission sheds it.
        """
        view = self._view(tenant)
        qb = np.ascontiguousarray(
            check_points(pts, name="probe points", dims=(2, 3),
                         allow_empty=True), np.float32)
        snap = view.store.current()
        if snap.n_points and qb.size and qb.shape[1] != snap.d:
            raise ValueError(f"dimensionality mismatch: tenant "
                             f"{view.name!r} serves {snap.d}-d, got "
                             f"{qb.shape[1]}-d probes")
        fut: Future = Future()
        if len(qb) == 0:                # trivially complete; skip queues
            fut.set_result(QueryReply(
                np.full(0, -1, np.int32), np.zeros(0, np.int32),
                np.zeros(0, bool), snap.version, view.name))
            return fut
        if len(qb) > self.config.max_batch:
            raise ValueError(f"request of {len(qb)} probes exceeds "
                             f"max_batch={self.config.max_batch}; split "
                             "it client-side")
        self.admission.admit_query(len(qb))
        obs_metrics.inc(obs_names.SERVE_REQUESTS, kind="query",
                        tenant=view.name)
        req = batching.Request(qb, fut, time.monotonic())
        hot = self._batchers[view.name].add(req)
        with self._qcond:
            self._qcond.notify()
        del hot                          # add() already queued; the wake
        return fut                       # covers full and deadline alike

    def query(self, pts, *, tenant: str | None = None,
              timeout: float | None = None) -> QueryReply:
        """Blocking convenience around :meth:`submit_query`."""
        return self.submit_query(pts, tenant=tenant).result(timeout)

    def submit_insert(self, pts) -> Future:
        """Admit one insert batch; resolves to an :class:`InsertReply`
        once **every** tenant has applied and republished.

        Raises ValueError synchronously for malformed batches and
        :class:`Overloaded` when the write queue is full.
        """
        batch = np.ascontiguousarray(
            check_points(pts, name="points", dims=(2, 3)), np.float32)
        self.admission.admit_insert()
        obs_metrics.inc(obs_names.SERVE_REQUESTS, kind="insert",
                        tenant="")
        fut: Future = Future()
        with self._wcond:
            self._inserts.append(_InsertReq(batch, fut, time.monotonic()))
            self._wcond.notify()
        return fut

    def insert(self, pts, *, timeout: float | None = None) -> InsertReply:
        """Blocking convenience around :meth:`submit_insert`."""
        return self.submit_insert(pts).result(timeout)

    def stats(self) -> dict:
        """Queue depths, shed counts, SLO quantiles, per-tenant state."""
        st = self.admission.stats(tenants=self.tenants + ("",))
        st["tenants"] = [v.stats() for v in self._views]
        st["apply_failures"] = self._apply_failures
        st["stopped"] = self._stopped
        return st

    # ------------------------------------------------------------------ #
    # lifecycle                                                          #
    # ------------------------------------------------------------------ #

    def shutdown(self, *, drain: bool = True,
                 final_checkpoint: bool = True) -> None:
        """Stop serving: close admission, drain (or abandon) queued work,
        write final checkpoints, join the planes.  Idempotent."""
        if self._stopped:
            return
        self.admission.close()
        if not drain:
            self._fail_pending(RuntimeError("server shut down "
                                            "without drain"))
        with self._qcond:
            self._draining = True
            self._qcond.notify_all()
        with self._wcond:
            self._wcond.notify_all()
        self._wthread.join(self.config.drain_timeout_s)
        self._qthread.join(self.config.drain_timeout_s)
        self._stopped = True
        if final_checkpoint and self._durability_dir is not None:
            for v in self._views:
                v.handle.checkpoint()
        obs_metrics.inc("serve_shutdowns_total")

    def _fail_pending(self, exc: Exception) -> None:
        with self._wcond:
            pending, self._inserts = self._inserts, []
        for req in pending:
            self.admission.release_insert()
            req.future.set_exception(exc)
        now = time.monotonic()
        for name, b in self._batchers.items():
            for fl in b.drain(now):
                for r in fl.requests:
                    self.admission.release_query(len(r.pts))
                    r.future.set_exception(exc)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------ #
    # query plane                                                        #
    # ------------------------------------------------------------------ #

    def _pop_ready(self, now: float, drain: bool = False):
        for v in self._views:
            fl = self._batchers[v.name].ready(now, drain=drain)
            if fl is not None:
                return v, fl
        return None

    def _on_device(self, stream=None):
        """This thread's CUDA device (and ``stream``) for the block; a
        no-op context on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if stream is None:
            return torch.cuda.device(self.device)
        return torch.cuda.stream(stream)

    def _query_loop(self) -> None:
        # queries run on their own stream, beside the writer's: see the
        # class docstring
        with self._on_device(self._qstream):
            self._query_batches()

    def _query_batches(self) -> None:
        while True:
            with self._qcond:
                while True:
                    now = time.monotonic()
                    item = self._pop_ready(now, drain=self._draining)
                    if item is not None:
                        break
                    if self._draining:
                        return
                    deadlines = [d for d in
                                 (b.next_deadline(now)
                                  for b in self._batchers.values())
                                 if d is not None]
                    if deadlines:
                        self._qcond.wait(max(min(deadlines) - now, 1e-4))
                    else:
                        self._qcond.wait()
            self._execute(*item)

    def _execute(self, view: tenants_mod.TenantView,
                 fl: batching.Flush) -> None:
        # one version for the whole flush; ``snap`` stays referenced until
        # its results are on the host (see SnapshotStore)
        snap = view.store.current()
        try:
            res = snap.query(fl.pts)
        except Exception as e:          # pragma: no cover — defensive
            for r in fl.requests:
                self.admission.release_query(len(r.pts))
                r.future.set_exception(e)
            return
        done = time.monotonic()
        off = 0
        for r in fl.requests:
            k = len(r.pts)
            r.future.set_result(QueryReply(
                res.labels[off:off + k], res.counts[off:off + k],
                res.would_be_core[off:off + k], snap.version, view.name))
            off += k
            self.admission.release_query(k)
            self.admission.observe("query", done - r.arrived_at,
                                   tenant=view.name)

    # ------------------------------------------------------------------ #
    # write plane                                                        #
    # ------------------------------------------------------------------ #

    def _write_loop(self) -> None:
        with self._on_device():
            self._write_batches()

    def _write_batches(self) -> None:
        while True:
            with self._wcond:
                while not self._inserts and not self._draining:
                    self._wcond.wait()
                if not self._inserts:
                    if self._unpublished:
                        self._publish_all()
                    return              # draining and empty: done
                req = self._inserts.pop(0)
            self._apply(req)

    def _apply(self, req: _InsertReq) -> None:
        try:
            with obs_trace.span("serve.apply", k=len(req.pts)):
                for v in self._views:
                    v.handle.insert(req.pts)
            self._unpublished += 1
            if self._unpublished >= self.config.publish_every:
                self._publish_all()
            versions = {v.name: v.store.version for v in self._views}
            watermark = self._views[0].handle.n_points
        except Exception as e:
            # the batch passed validation, so this is an internal error:
            # fail the future, keep the old snapshots serving (they were
            # never swapped), and keep answering queries
            self._apply_failures += 1
            obs_metrics.inc(obs_names.SERVE_APPLY_FAILURES)
            self.admission.release_insert()
            req.future.set_exception(e)
            return
        self.admission.release_insert()
        done = time.monotonic()
        req.future.set_result(InsertReply(watermark, versions))
        self.admission.observe("insert", done - req.arrived_at)

    def _publish_all(self) -> None:
        with obs_trace.span("serve.publish"):
            for v in self._views:
                v.publish()
        self._unpublished = 0
