"""Clustering CLI — the paper's algorithms as a runnable tool (the port of
``repro.launch.cluster``, same flags, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.cluster --data hacc_like \
      -n 20000 --eps 0.03 --minpts 5 --algorithm fdbscan-densebox

Runs on the current CUDA device unless ``--device cpu`` is given (and
refuses to run without one). ``--trace``/``--metrics-json`` record the
run's phase spans (plan/build/traverse/sweep/border) and metrics snapshot
through ``repro_torch.obs``. A ``pallas-tree`` plan (``auto`` on the card
names one) prints its tuner decision (``REPRO_TUNE``: off, heuristic,
search).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_RING = "ROADMAP Queue 1 item 2 (distributed/)"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default="blobs",
                    help="dataset name (data/pointclouds.py) or .npy path")
    ap.add_argument("-n", type=int, default=10000)
    ap.add_argument("--eps", type=float, required=True)
    ap.add_argument("--minpts", type=int, required=True)
    ap.add_argument("--algorithm", default="auto",
                    choices=["auto", "fdbscan", "fdbscan-densebox", "tiled",
                             "pallas-tree", "gdbscan", "ring"])
    ap.add_argument("--star", action="store_true", help="DBSCAN* variant")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write labels .npy")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics registry snapshot here at exit")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record phase spans; write Chrome trace JSON here")
    ap.add_argument("--device", default=None,
                    help="where the index lives and every walk runs "
                    "(default: the current CUDA device; 'cpu' runs the "
                    "plain versions on the host)")
    args = ap.parse_args(argv)

    from repro_torch.core import dispatch
    try:
        args.device = dispatch.resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    prev_reg, prev_tr = obs_metrics.active(), obs_trace.active()
    reg = tracer = None
    if args.metrics_json:
        reg = obs_metrics.install(obs_metrics.Registry())
    if args.trace:
        tracer = obs_trace.install(sync=True)
    try:
        return _run(args, reg, tracer)
    finally:
        obs_metrics.install(prev_reg) if prev_reg is not None \
            else obs_metrics.uninstall()
        obs_trace.install(prev_tr) if prev_tr is not None \
            else obs_trace.uninstall()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(args, reg, tracer) -> dict:
    from repro_torch.core import dispatch
    from repro_torch.data import pointclouds
    pts = pointclouds.load(args.data, args.n, seed=args.seed)
    print(f"[cluster] {args.data}: n={len(pts)} d={pts.shape[1]} "
          f"eps={args.eps} minpts={args.minpts} algo={args.algorithm} "
          f"device={args.device}")

    tuned = None
    _sync(args.device)
    t0 = time.time()
    if args.algorithm == "tiled":
        from repro_torch.kernels import dbscan_tiled
        res = dbscan_tiled(dispatch.as_points(pts, args.device), args.eps,
                           args.minpts)
    elif args.algorithm == "gdbscan":
        from repro_torch.core import gdbscan
        res = gdbscan(pts, args.eps, args.minpts, device=args.device)
    elif args.algorithm == "ring":
        raise NotImplementedError(
            f"--algorithm ring is not supported yet: {_RING}")
    else:
        p = dispatch.plan(pts, args.eps, args.minpts, args.algorithm,
                          device=args.device)
        if p.tune is not None:
            tuned = p.tune.describe()
            print(f"[cluster] tuned_config {json.dumps(tuned)}")
        res = dispatch.dbscan(pts, args.eps, args.minpts, star=args.star,
                              query_plan=p)
    _sync(args.device)
    dt = time.time() - t0
    labels = res.labels.cpu().numpy()
    n_noise = int((labels == -1).sum())
    sizes = np.bincount(labels[labels >= 0]) if res.n_clusters else []
    print(f"[cluster] {res.n_clusters} clusters, {n_noise} noise "
          f"({100*n_noise/len(pts):.1f}%), "
          f"core={int(res.core_mask.sum())}, "
          f"sweeps={res.n_sweeps}, {dt:.2f}s (incl. kernel builds)")
    if len(sizes):
        print(f"[cluster] largest clusters: {sorted(sizes)[-5:][::-1]}")
    if args.out:
        np.save(args.out, labels)
        print(f"[cluster] labels -> {args.out}")
    if reg is not None and args.metrics_json:
        obs_metrics.validate_snapshot(reg.write_json(args.metrics_json))
        print(f"[cluster] metrics snapshot -> {args.metrics_json}")
    if tracer is not None and args.trace:
        doc = tracer.export(args.trace)
        print(f"[cluster] Chrome trace ({len(doc['traceEvents'])} events) "
              f"-> {args.trace}")
    return {"n_clusters": res.n_clusters, "n_sweeps": res.n_sweeps,
            "backend": getattr(res, "backend", ""), "seconds": dt,
            "tuned_config": tuned}


if __name__ == "__main__":
    main()
