"""Per-lane readings of the walks in a sweep cell's resident calls.

    python3 tools/walk_lanes.py [--config ngsim porto hacc] [--device cuda]
        [--n N]

Draws each configuration's resident set as the sweep cells draw it
(``bench/configs/<config>.json``, its ``data_seed``), runs one
``repro_torch.dbscan(..., algorithm="auto")`` call per ``min_pts`` of its
sweep, and reads every walk of the call (the first pass, each label
sweep, the border) where ``fdbscan._record_trace`` receives it: per lane,
its member distance tests (``evals``) and its loop trips (``iters``), and
whether its point lies in a dense cell. Prints one JSON line a call:

- ``lanes``, ``evals``, ``loose_evals_share``: lanes and tests over the
  call's walks, and the share of the tests made by lanes outside every
  dense cell;
- ``lane_evals_max``, ``lane_iters_max``: the longest lane of any walk;
- ``evals_share_long``: the share of the tests made by lanes that test
  more than ``LONG`` members in one walk;
- ``warp32_share``: the call's trips over 32 times the longest trip count
  of each run of 32 lanes in launch order, summed over walks: the share of
  a warp's thread-trips that do work if each warp kept its first 32 lanes
  (the kernel refills a warp's idle threads once ``kRefill`` of them are
  idle, so it does better than this except at a walk's tail);
- ``tail_trips``: the walks' trip floor less their balanced trips, summed
  over the call's walks: a walk's balanced trips are its trips over the
  card's resident threads (``multi_processor_count *
  max_threads_per_multi_processor``, an upper bound of the walk's), its
  floor the larger of that and its longest lane, so this is the part of
  the floor that single long lanes set.

The program is run as it is; only the function that folds a walk's
counters into the metrics registry is wrapped, to see the walk's lanes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from bench import data  # noqa: E402

LONG = 1024


class Lanes:
    """Sums over the walks of one call."""

    def __init__(self, threads: int):
        self.threads = threads
        self.walks = 0
        self.lanes = 0
        self.evals = 0
        self.loose = 0
        self.long = 0
        self.evals_max = 0
        self.iters_max = 0
        self.trips = 0
        self.warp_trips = 0
        self.balanced = 0.0
        self.floor = 0.0

    def add(self, tr, segs, ids) -> None:
        ev = tr.evals.long()
        it = tr.iters.long()
        dense = segs.dense_pt if ids is None else segs.dense_pt[ids.long()]
        n = ev.numel()
        self.walks += 1
        if n == 0:
            return
        pad = (-n) % 32
        groups = torch.nn.functional.pad(it, (0, pad)).view(-1, 32)
        got = torch.stack([ev.sum(), torch.where(dense, 0, ev).sum(),
                           torch.where(ev > LONG, ev, 0).sum(), ev.max(),
                           it.max(), it.sum(),
                           32 * groups.amax(1).sum()]).tolist()
        evals, loose, long_, ev_max, it_max, trips, warp = got
        self.lanes += n
        self.evals += evals
        self.loose += loose
        self.long += long_
        self.evals_max = max(self.evals_max, ev_max)
        self.iters_max = max(self.iters_max, it_max)
        self.trips += trips
        self.warp_trips += warp
        self.balanced += trips / self.threads
        self.floor += max(float(it_max), trips / self.threads)

    def summary(self) -> dict:
        def share(a, b):
            return a / b if b else 0.0
        return {"walks": self.walks, "lanes": self.lanes,
                "evals": self.evals,
                "loose_evals_share": share(self.loose, self.evals),
                "lane_evals_max": self.evals_max,
                "lane_iters_max": self.iters_max,
                "evals_share_long": share(self.long, self.evals),
                "warp32_share": share(self.trips, self.warp_trips),
                "tail_trips": self.floor - self.balanced}


def watch(threads: int):
    """Wrap ``fdbscan._record_trace``; returns a function that starts a
    new call's sums and returns the last one's."""
    from repro_torch.core import fdbscan
    inner = fdbscan._record_trace
    box = {"cur": Lanes(threads)}

    def record(phase, engine, tr, segs, ids=None):
        box["cur"].add(tr, segs, ids)
        return inner(phase, engine, tr, segs, ids)

    fdbscan._record_trace = record

    def take() -> Lanes:
        got, box["cur"] = box["cur"], Lanes(threads)
        return got
    return take


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", nargs="+", default=["ngsim", "porto", "hacc"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="points to draw (default: the configuration's n)")
    args = ap.parse_args(argv)
    import repro_torch
    dev = torch.device(args.device)
    threads = 1
    if dev.type == "cuda":
        p = torch.cuda.get_device_properties(dev)
        threads = p.multi_processor_count * p.max_threads_per_multi_processor
    take = watch(threads)
    for name in args.config:
        with open(os.path.join(ROOT, "bench", "configs",
                               f"{name}.json")) as f:
            cfg = json.load(f)
        pts = data.draw(cfg, data.catalog(cfg), args.n or int(cfg["n"]),
                        data.derive_seed(int(cfg["data_seed"])), dev)
        eps = float(cfg["eps"])
        for m in cfg["min_pts_sweep"]:
            repro_torch.dbscan(pts, eps, int(m), device=dev)  # the plan
            take()
            t = time.perf_counter()
            res = repro_torch.dbscan(pts, eps, int(m), device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t
            print(json.dumps(dict(config=name, min_pts=int(m),
                                  sweeps=int(res.n_sweeps),
                                  call_s_with_reads=wall,
                                  **take().summary())), flush=True)
        del pts
    return 0


if __name__ == "__main__":
    sys.exit(main())
