"""Streaming DBSCAN serving loop (DESIGN.md §7, durability §10, obs §12).

The port of ``repro.launch.serve``, on the current CUDA device unless
``--device cpu`` is given: a long-lived ``StreamingDBSCAN`` handle
absorbing a mixed stream of *insert* and *query* requests, drained in
fixed-size micro-batches (``--batch`` points per operation).

Bootstrap routes through ``core.dispatch.dbscan`` (plan caching + backend
auto-selection), and the handle itself is built with
``dispatch.stream_handle`` so it reuses the very same cached
eps-independent index instead of rebuilding it.

Sliding windows: ``--window W`` keeps only the most recent W inserted
points live — every insert auto-expires the rest by insert-order
watermark (tombstones + demotion repair, DESIGN.md §11), the workload
the ngsim_like trajectory scenario actually needs.

Durability (DESIGN.md §10): ``--wal`` logs every insert/delete/expire
micro-batch before it is applied, ``--checkpoint`` +
``--checkpoint-every`` write atomic snapshots of the whole index, and
``--restore`` recovers the handle (checkpoint + WAL replay) after a
crash and keeps serving where the stream left off:

  PYTHONPATH=src python -m repro_torch.launch.serve --dataset blobs \
      --n 8192 --eps 0.04 --min-pts 8 --batch 256 --steps 60 \
      --insert-frac 0.3 --wal state/serve.wal --checkpoint state/serve.npz \
      --checkpoint-every 1
  # kill -9 it mid-run, then:
  PYTHONPATH=src python -m repro_torch.launch.serve ... --restore

Observability (DESIGN.md §12): the loop always runs against a local
metrics registry — request latencies go into *bounded-memory* quantile
histograms (``serve_insert_seconds`` / ``serve_query_seconds`` /
``serve_snapshot_seconds``; the sketch size is bounded by the latency
range, never by the request count, so a long-lived server stays
memory-flat), and every handle counter (merges, compactions, repair
sweeps, WAL fsyncs) reports into the same registry.  ``--metrics-json``
writes the schema-stable snapshot at exit, ``--trace`` additionally
records phase spans and writes a Chrome trace (open in Perfetto /
``chrome://tracing``; pass ``--trace-sync`` to block on device values at
span close so spans measure compute, not dispatch), and
``--stats-every K`` prints registry-derived latency lines during the run.

The loop is defensive the way a serving process must be: an exhausted
insert pool degrades to query-only service (dropped insert requests are
counted, not fatal), malformed request batches (NaN/Inf coordinates) are
rejected by the validation gate and counted instead of corrupting the
index, and ``--validate`` failures exit non-zero with a readable error
(in server mode every tenant's final snapshot is checked).

Multi-tenant server mode (DESIGN.md §13): ``--tenants name:eps:min_pts[,
...]`` swaps the bare handle for :class:`repro_torch.serve.Server` —
adaptive
micro-batching, immutable versioned snapshots, per-tenant views over one
shared index build, and admission control.  ``--durability-dir DIR``
gives every tenant its own WAL + checkpoint files there, and
``--restore`` recovers the whole server from them:

  PYTHONPATH=src python -m repro_torch.launch.serve --dataset blobs \
      --n 8192 --tenants tight:0.02:10,coarse:0.05:5 --steps 40 \
      --durability-dir state/serve

Graceful shutdown (both modes): SIGTERM or Ctrl-C finishes the request
in flight, drains everything already admitted, writes a final durable
checkpoint, prints the summary, and exits 0 — a supervisor's ``kill``
is a clean restart, never data loss.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def _install_shutdown() -> threading.Event:
    """Route SIGTERM/SIGINT into a drain flag (main thread only; worker
    threads and embedded callers are unaffected)."""
    ev = threading.Event()

    def _handler(signum, frame):
        if ev.is_set():              # second signal: operator insists
            raise KeyboardInterrupt
        ev.set()
        print(f"[serve] caught {signal.Signals(signum).name}: draining, "
              "will checkpoint and exit 0", file=sys.stderr)

    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    except ValueError:               # not the main thread (embedded use)
        pass
    return ev


def _parse_tenants(spec: str):
    """``name:eps:min_pts[,name:eps:min_pts...]`` -> TenantSpec list."""
    from repro_torch.serve import TenantSpec
    out = []
    for part in spec.split(","):
        bits = part.strip().split(":")
        if len(bits) != 3:
            raise ValueError(f"bad tenant spec {part!r}: want "
                             "name:eps:min_pts")
        out.append(TenantSpec(bits[0], float(bits[1]), int(bits[2])))
    return out


def _q_ms(reg, name: str, q: float) -> float:
    """Quantile (in ms) of a registry latency histogram; NaN when empty."""
    h = reg.get(name)
    if h is None or h.count == 0:
        return float("nan")
    return h.quantile(q) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="blobs",
                    help="pointclouds dataset name or .npy path")
    ap.add_argument("--n", type=int, default=8192,
                    help="total points backing the request stream")
    ap.add_argument("--warm-frac", type=float, default=0.5,
                    help="fraction of points clustered at bootstrap")
    ap.add_argument("--eps", type=float, default=0.04)
    ap.add_argument("--min-pts", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256,
                    help="micro-batch size (points per insert or query)")
    ap.add_argument("--steps", type=int, default=60,
                    help="number of micro-batches to serve")
    ap.add_argument("--insert-frac", type=float, default=0.3,
                    help="probability a step drains inserts (vs queries); "
                    "0 serves a query-only stream, 1 insert-only")
    ap.add_argument("--window", type=int, default=None, metavar="W",
                    help="sliding window: every insert auto-expires points "
                    "older than the last W inserted (tombstones + demotion "
                    "repair, DESIGN.md §11)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="materialize labels every K steps (0: only final)")
    ap.add_argument("--validate", action="store_true",
                    help="check the final snapshot (every tenant's in "
                    "server mode) against batch dbscan (exits 1 with a "
                    "readable error on mismatch)")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="write-ahead log: every insert batch is appended "
                    "+ fsynced here before it is applied")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint .npz path (atomic tmp+fsync+rename)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                    help="auto-checkpoint every K merges (needs --checkpoint)")
    ap.add_argument("--restore", action="store_true",
                    help="recover from --checkpoint/--wal instead of a cold "
                    "bootstrap, then keep serving the rest of the stream")
    ap.add_argument("--poison-frac", type=float, default=0.0,
                    help="probability a request batch carries a NaN point "
                    "(exercises the validation gate; rejected + counted)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics registry snapshot "
                    "(repro.obs schema) here at exit")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record phase spans and write a Chrome trace-event "
                    "JSON here at exit (Perfetto / chrome://tracing)")
    ap.add_argument("--trace-sync", action="store_true",
                    help="block on watched device values at span close so "
                    "spans measure compute, not dispatch (observer cost is "
                    "marked in the trace); default: never block")
    ap.add_argument("--stats-every", type=int, default=0, metavar="K",
                    help="print registry-derived latency stats every K steps")
    ap.add_argument("--tenants", default=None, metavar="SPECS",
                    help="multi-tenant server mode: name:eps:min_pts[,...] "
                    "— serve every view over one shared index via "
                    "repro_torch.serve.Server (ignores --eps/--min-pts)")
    ap.add_argument("--durability-dir", default=None, metavar="DIR",
                    help="server mode: per-tenant WAL + checkpoint files "
                    "live here (<name>.wal / <name>.npz)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="server mode: micro-batching deadline — the "
                    "longest a query may wait for co-travelers")
    ap.add_argument("--device", default=None,
                    help="where the index lives and every walk and query "
                    "runs (default: the current CUDA device; 'cpu' runs "
                    "the plain versions on the host)")
    args = ap.parse_args(argv)

    if args.tenants:
        if args.wal or args.checkpoint:
            ap.error("server mode persists per tenant: use "
                     "--durability-dir, not --wal/--checkpoint")
        if args.restore and not args.durability_dir:
            ap.error("--restore in server mode needs --durability-dir")
    else:
        if args.restore and not (args.checkpoint or args.wal):
            ap.error("--restore needs --checkpoint and/or --wal")
        if args.checkpoint_every and not args.checkpoint:
            ap.error("--checkpoint-every needs --checkpoint")

    from repro_torch.core import dispatch
    try:
        args.device = dispatch.resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    # The serving loop always collects into its own registry (bounded
    # histograms replace the old unbounded all-time latency lists); the
    # tracer is only installed when a trace is requested.  Previous
    # collectors are restored on the way out, so embedding callers (the
    # tests) never see their instrumentation hijacked.
    prev_reg, prev_tr = obs_metrics.active(), obs_trace.active()
    reg = obs_metrics.install(obs_metrics.Registry())
    tracer = None
    if args.trace:
        tracer = obs_trace.install(sync=args.trace_sync)
    try:
        if args.tenants:
            return _serve_multi(args, reg, tracer)
        return _serve(args, reg, tracer)
    finally:
        obs_metrics.install(prev_reg) if prev_reg is not None \
            else obs_metrics.uninstall()
        obs_trace.install(prev_tr) if prev_tr is not None \
            else obs_trace.uninstall()


def _serve(args, reg, tracer):
    from repro_torch.core import dispatch
    from repro_torch.data import pointclouds
    from repro_torch.stream import StreamingDBSCAN

    pts = pointclouds.load(args.dataset, args.n, seed=args.seed)
    n0 = max(2, int(args.n * args.warm_frac))
    initial, pool = pts[:n0], pts[n0:]
    rng = np.random.default_rng(args.seed)
    B, d = args.batch, pts.shape[1]

    t0 = time.perf_counter()
    if args.restore:
        # Crash recovery: latest valid checkpoint + WAL replay past its
        # watermark (DESIGN.md §10). The stream is deterministic (initial
        # prefix, then the pool in order), so the recovered watermark tells
        # us exactly where to resume draining the pool.
        with obs_trace.span("serve.restore"):
            handle = StreamingDBSCAN.restore(
                args.checkpoint, wal=args.wal, window=args.window,
                checkpoint_every=args.checkpoint_every, device=args.device)
            boot = handle.snapshot()
        t_boot = time.perf_counter() - t0
        pool_off = min(max(handle.n_points - n0, 0), len(pool))
        print(f"[serve] restored n={handle.n_points} "
              f"(watermark resumes pool at +{pool_off}): "
              f"{boot.n_clusters} clusters in {t_boot:.2f}s")
    else:
        # Bootstrap through the unified dispatcher: stream_handle plans via
        # dispatch (algorithm="stream"), so the handle's main tree is the
        # plan cache's eps-independent index — later batch dbscan calls or
        # handles at other eps/min_pts over the same points reuse it. The
        # handle's own bootstrap clustering doubles as the t0 snapshot.
        with obs_trace.span("serve.bootstrap", n=n0):
            handle = dispatch.stream_handle(
                initial, args.eps, args.min_pts, window=args.window,
                wal=args.wal, checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every, device=args.device)
            boot = handle.snapshot()
        t_boot = time.perf_counter() - t0
        pool_off = 0
        print(f"[serve] bootstrap n={n0} via backend={boot.backend!r}: "
              f"{boot.n_clusters} clusters in {t_boot:.2f}s "
              f"(index cached for reuse across parameter sweeps)")

    def query_batch():
        idx = rng.integers(0, len(pts), B)
        jitter = rng.normal(0.0, 0.2 * args.eps, (B, d)).astype(np.float32)
        return pts[idx] + jitter

    def poisoned(batch):
        if args.poison_frac and rng.random() < args.poison_frac:
            batch = batch.copy()
            batch[rng.integers(0, len(batch))] = np.nan
        return batch

    # warm-up query (kernel load, outside the latency measurements)
    handle.query(query_batch())

    stop = _install_shutdown()
    n_ins = n_q = n_dropped = n_rejected = 0
    for step in range(args.steps):
        if stop.is_set():
            # graceful drain: stop taking new steps; the epilogue below
            # still checkpoints and reports, and we exit 0
            print(f"[serve] drained after {step} steps", file=sys.stderr)
            break
        want_insert = rng.random() < args.insert_frac
        if want_insert and pool_off >= len(pool):
            # Insert stream ran dry: a real server keeps answering queries.
            n_dropped += 1
            obs_metrics.inc("serve_dropped_total", kind="insert")
            want_insert = False
        if want_insert:
            take = poisoned(pool[pool_off:pool_off + B])
            t0 = time.perf_counter()
            try:
                with obs_trace.span("serve.request", kind="insert",
                                    step=step):
                    handle.insert(take)
            except ValueError as e:
                n_rejected += 1
                obs_metrics.inc("serve_rejected_total", kind="insert")
                print(f"[serve] step {step + 1}: insert rejected "
                      f"({str(e).splitlines()[0]})", file=sys.stderr)
            else:
                obs_metrics.observe("serve_insert_seconds",
                                    time.perf_counter() - t0)
                n_ins += len(take)
            # rejected or not, that slice of the stream is consumed
            pool_off += len(pool[pool_off:pool_off + B])
        else:
            qb = poisoned(query_batch())
            t0 = time.perf_counter()
            try:
                with obs_trace.span("serve.request", kind="query",
                                    step=step):
                    handle.query(qb)
            except ValueError as e:
                n_rejected += 1
                obs_metrics.inc("serve_rejected_total", kind="query")
                print(f"[serve] step {step + 1}: query rejected "
                      f"({str(e).splitlines()[0]})", file=sys.stderr)
            else:
                obs_metrics.observe("serve_query_seconds",
                                    time.perf_counter() - t0)
                n_q += B
        obs_metrics.set_gauge("serve_pool_remaining",
                              float(len(pool) - pool_off))
        if args.snapshot_every and (step + 1) % args.snapshot_every == 0:
            t0 = time.perf_counter()
            snap = handle.snapshot()
            dt = time.perf_counter() - t0
            obs_metrics.observe("serve_snapshot_seconds", dt)
            print(f"[serve] step {step + 1}: n={handle.n_points} "
                  f"(delta {handle.n_delta}), {snap.n_clusters} clusters, "
                  f"snapshot {dt * 1e3:.1f}ms")
        if args.stats_every and (step + 1) % args.stats_every == 0:
            print(f"[serve] step {step + 1}: "
                  f"insert p50 {_q_ms(reg, 'serve_insert_seconds', .5):.1f}ms "
                  f"query p50 {_q_ms(reg, 'serve_query_seconds', .5):.1f}ms "
                  f"(active {handle.n_active}, tiers {handle.n_tiers})")

    if args.checkpoint:
        handle.checkpoint()          # final durable state before reporting

    t0 = time.perf_counter()
    snap = handle.snapshot()
    t_snap = time.perf_counter() - t0
    obs_metrics.observe("serve_snapshot_seconds", t_snap)
    ins_h, q_h = reg.get("serve_insert_seconds"), reg.get("serve_query_seconds")
    stats = {
        "steps": args.steps, "batch": B,
        "n_points": handle.n_points, "n_inserted": n_ins, "n_queried": n_q,
        "n_dropped": n_dropped, "n_rejected": n_rejected,
        "n_active": handle.n_active, "n_tombstoned": handle.n_tombstoned,
        "n_merges": handle.n_merges,
        "n_compactions": handle.n_compactions,
        "n_deletes": handle.n_deletes,
        "repair_sweeps": handle.n_repair_sweeps,
        "insert_p50_ms": _q_ms(reg, "serve_insert_seconds", 0.50),
        "insert_p99_ms": _q_ms(reg, "serve_insert_seconds", 0.99),
        "insert_pts_per_s": (n_ins / ins_h.sum
                             if ins_h is not None and ins_h.sum > 0
                             else float("nan")),
        "query_p50_ms": _q_ms(reg, "serve_query_seconds", 0.50),
        "query_p99_ms": _q_ms(reg, "serve_query_seconds", 0.99),
        "snapshot_s": t_snap, "n_clusters": snap.n_clusters,
        # memory-flatness witness: sketch buckets, not sample counts
        "latency_sketch_buckets": ((ins_h.bucket_count() if ins_h else 0)
                                   + (q_h.bucket_count() if q_h else 0)),
    }
    print(f"[serve] {args.dataset}: served {args.steps} micro-batches "
          f"(B={B}) -> {stats['n_active']} active pts "
          f"(+{stats['n_tombstoned']} tombstoned), "
          f"{stats['n_clusters']} clusters, {stats['n_merges']} merges, "
          f"{stats['n_compactions']} compactions, "
          f"{n_dropped} dropped, {n_rejected} rejected")
    print(f"[serve] insert: p50 {stats['insert_p50_ms']:.1f}ms "
          f"p99 {stats['insert_p99_ms']:.1f}ms "
          f"({stats['insert_pts_per_s']:.0f} pts/s); "
          f"query: p50 {stats['query_p50_ms']:.1f}ms "
          f"p99 {stats['query_p99_ms']:.1f}ms; "
          f"snapshot {t_snap:.2f}s")

    if args.metrics_json:
        obs_metrics.validate_snapshot(reg.write_json(args.metrics_json))
        print(f"[serve] metrics snapshot -> {args.metrics_json}")
    if tracer is not None and args.trace:
        doc = tracer.export(args.trace)
        print(f"[serve] Chrome trace ({len(doc['traceEvents'])} events) "
              f"-> {args.trace}")

    if args.validate:
        _validate(handle, args.eps, args.min_pts, args.device, snap)
        print("[serve] validation against batch dbscan ✓")
    return stats


def _validate(handle, eps: float, min_pts: int, device, snap=None,
              what: str = "snapshot") -> None:
    """Exit 1 with a readable error unless the handle's snapshot is
    component-identical to batch fdbscan on its active points."""
    from repro_torch.core import dispatch
    from repro_torch.core.validate import check_component_identical
    snap = snap if snap is not None else handle.snapshot()
    ref = dispatch.dbscan(handle.points, eps, min_pts, algorithm="fdbscan",
                          device=device)
    try:
        check_component_identical(snap.labels.cpu().numpy(),
                                  snap.core_mask.cpu().numpy(),
                                  ref.labels.cpu().numpy(),
                                  ref.core_mask.cpu().numpy())
    except (AssertionError, ValueError) as e:
        print(f"[serve] validation FAILED: {what} is not "
              f"component-identical to batch dbscan on the same "
              f"points — {e}", file=sys.stderr)
        raise SystemExit(1)


def _serve_multi(args, reg, tracer):
    """Multi-tenant server mode: drive a
    :class:`repro_torch.serve.Server`.

    Each step fires a burst of query requests (round-robin over tenants,
    sized ``--batch`` split across 4 requests so the micro-batcher has
    something to coalesce) and with probability ``--insert-frac`` one
    insert batch.  SIGTERM/Ctrl-C drains admitted work, checkpoints every
    tenant, and exits 0.
    """
    from repro_torch.data import pointclouds
    from repro_torch.serve import Overloaded, Server, ServerConfig

    specs = _parse_tenants(args.tenants)
    pts = pointclouds.load(args.dataset, args.n, seed=args.seed)
    n0 = max(2, int(args.n * args.warm_frac))
    initial, pool = pts[:n0], pts[n0:]
    rng = np.random.default_rng(args.seed)
    B, d = args.batch, pts.shape[1]
    cfg = ServerConfig(max_batch=max(B, 64),
                       max_delay_s=args.max_delay_ms * 1e-3)

    t0 = time.perf_counter()
    if args.restore:
        srv = Server.restore(specs, durability_dir=args.durability_dir,
                             config=cfg, window=args.window,
                             checkpoint_every=args.checkpoint_every,
                             device=args.device)
        pool_off = min(max(srv._views[0].handle.n_points - n0, 0), len(pool))
        print(f"[serve] restored {len(specs)} tenants at watermark "
              f"{srv._views[0].handle.n_points} in "
              f"{time.perf_counter() - t0:.2f}s")
    else:
        srv = Server(initial, specs, config=cfg,
                     durability_dir=args.durability_dir,
                     window=args.window,
                     checkpoint_every=args.checkpoint_every,
                     device=args.device)
        pool_off = 0
        print(f"[serve] bootstrap n={n0}, {len(specs)} tenants over one "
              f"shared index in {time.perf_counter() - t0:.2f}s")

    def query_batch(k):
        idx = rng.integers(0, len(pts), k)
        eps0 = specs[0].eps
        jitter = rng.normal(0.0, 0.2 * eps0, (k, d)).astype(np.float32)
        return pts[idx] + jitter

    stop = _install_shutdown()
    n_q = n_ins = n_shed = 0
    steps = 0
    with srv:
        for step in range(args.steps):
            if stop.is_set():
                print(f"[serve] drained after {step} steps",
                      file=sys.stderr)
                break
            steps = step + 1
            futs = []
            per = max(B // 4, 1)
            for j in range(4):
                spec = specs[(step * 4 + j) % len(specs)]
                try:
                    futs.append(srv.submit_query(query_batch(per),
                                                 tenant=spec.name))
                except Overloaded:
                    n_shed += 1
            if rng.random() < args.insert_frac and pool_off < len(pool):
                take = pool[pool_off:pool_off + per]
                pool_off += len(take)
                try:
                    srv.insert(take, timeout=120)
                    n_ins += len(take)
                except Overloaded:
                    n_shed += 1
            for f in futs:
                f.result(timeout=120)
                n_q += per
            if args.stats_every and steps % args.stats_every == 0:
                st = srv.stats()
                print(f"[serve] step {steps}: query p50 "
                      f"{st['query_p50_s'] * 1e3:.1f}ms p99 "
                      f"{st['query_p99_s'] * 1e3:.1f}ms, shed {st['shed']}")
        stats = srv.stats()
        # context exit: admission closes, planes drain, final per-tenant
        # checkpoint through the durability path
    stats.update(steps=steps, n_queried=n_q, n_inserted=n_ins,
                 n_overloaded=n_shed)
    vers = {t["name"]: t["version"] for t in stats["tenants"]}
    print(f"[serve] served {steps} steps across {len(specs)} tenants: "
          f"{n_q} probes, {n_ins} inserts, {n_shed} shed; "
          f"versions {vers}")
    print(f"[serve] query p50 {stats['query_p50_s'] * 1e3:.1f}ms "
          f"p99 {stats['query_p99_s'] * 1e3:.1f}ms; "
          f"insert p50 {stats['insert_p50_s'] * 1e3:.1f}ms")

    if args.metrics_json:
        obs_metrics.validate_snapshot(reg.write_json(args.metrics_json))
        print(f"[serve] metrics snapshot -> {args.metrics_json}")
    if tracer is not None and args.trace:
        doc = tracer.export(args.trace)
        print(f"[serve] Chrome trace ({len(doc['traceEvents'])} events) "
              f"-> {args.trace}")
    if args.validate:
        for spec, view in zip(specs, srv._views):
            _validate(view.handle, spec.eps, spec.min_pts, args.device,
                      what=f"tenant {spec.name!r}'s snapshot")
        print(f"[serve] validation of {len(specs)} tenants against batch "
              "dbscan ✓")
    return stats


if __name__ == "__main__":
    main()
