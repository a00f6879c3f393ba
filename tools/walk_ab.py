"""Time the PyTorch/CUDA port's walks on one GPU, to compare two trees.

    python3 tools/walk_ab.py --src PATH/TO/src [--reps 7]

Imports ``repro_torch`` from ``--src`` (this tree's ``src``, or that of
another checkout, such as the parent commit unpacked by ``git archive``)
and drives the main path at the full sizes of ``chip_smoke.py``:
``hacc_like`` at 2,097,152 points and ``portotaxi_like`` at 1,048,576.
For each: the plan, one cold run, then ``--reps`` warm runs. In every warm
run CUDA events time the first pass and the first sweep (the run's walks 0
and 1) and the whole run; one more warm run under ``torch.profiler`` sums
the walk kernel's device time over all its launches (``walk_device_ms``)
and the device time of every kernel, copy and memset of the run
(``busy_device_ms``). It also times the two tile kernels and
``torch.cdist`` by device time at the tiled path's 1000 x 1000 shape.
Prints the card's name and power limit and one line ``[times] {json}``
with the medians and every sample.

Compare two trees only within one invocation on one card, in turns:
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

import torch

MAIN = [("hacc_like", 2_097_152, 0.00595, 5),
        ("portotaxi_like", 1_048_576, 0.00125, 50)]
TIMED = {0: "first_pass_ms", 1: "first_sweep_ms"}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int, name=None) -> float:
    """Mean device milliseconds of the CUDA kernels ``fn()`` launches
    (those whose name holds ``name``, or one of a tuple of names, or all),
    over ``reps`` runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (name is None or any(k in e.name for k in
                                      ((name,) if isinstance(name, str)
                                       else name))))
    return us / 1e3 / reps


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class WalkTimer:
    """Wraps ``fdbscan._walk`` to time the calls of one run listed in
    ``TIMED`` with CUDA events."""

    def __init__(self, fdbscan):
        self.fdbscan = fdbscan
        self.inner = fdbscan._walk
        self.calls = 0
        self.marks = {}

    def __call__(self, *args, **kw):
        i = self.calls
        self.calls += 1
        if i not in TIMED:
            return self.inner(*args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(*args, **kw)
        end.record()
        self.marks[i] = (start, end)
        return out

    def run(self, fn):
        self.calls, self.marks = 0, {}
        self.fdbscan._walk = self
        try:
            out = fn()
        finally:
            self.fdbscan._walk = self.inner
        torch.cuda.synchronize()
        return out, {TIMED[i]: s.elapsed_time(e)
                     for i, (s, e) in self.marks.items()}


def load_port(src: str):
    sys.path.insert(0, os.path.abspath(src))
    port = importlib.import_module("repro_torch")
    fdbscan = importlib.import_module("repro_torch.core.fdbscan")
    pointclouds = importlib.import_module("repro_torch.data.pointclouds")
    return port, fdbscan, pointclouds


def scenario(port, fdbscan, pointclouds, dset, n, eps, mp, reps: int):
    dev = torch.device("cuda", 0)
    pts = pointclouds.load(dset, n)
    timer = WalkTimer(fdbscan)
    torch.cuda.synchronize()
    plan = port.plan(pts, eps, mp, device=dev)
    res = port.dbscan(pts, eps, mp, query_plan=plan)        # cold

    def run():
        return port.dbscan(pts, eps, mp, query_plan=plan)

    samples = {"cluster_ms": [], **{k: [] for k in TIMED.values()}}
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res, walks = timer.run(run)
        end.record()
        torch.cuda.synchronize()
        samples["cluster_ms"].append(start.elapsed_time(end))
        for k, v in walks.items():
            samples[k].append(v)
    out = {k: statistics.median(v) for k, v in samples.items()}
    out.update(walk_device_ms=device_ms(run, 1, "walk_kernel"),
               busy_device_ms=device_ms(run, 1),
               n_sweeps=res.n_sweeps, n_clusters=res.n_clusters,
               n_traversals=res.n_traversals,
               core=int(res.core_mask.sum()), samples=samples)
    return out


def tiles() -> dict:
    pairwise = importlib.import_module("repro_torch.kernels.pairwise")
    g = torch.Generator(device="cpu").manual_seed(1)
    pts = torch.rand(1000, 2, generator=g).to("cuda")
    lab = torch.arange(1000, dtype=torch.int32, device="cuda")
    mask = torch.ones(1000, dtype=torch.bool, device="cuda")
    eps = 0.05
    return {
        "pairwise_count_device_ms": device_ms(
            lambda: pairwise.pairwise_count(pts, pts, eps, 5), 50,
            ("count_kernel", "pairwise_kernel")),
        "pairwise_minlabel_device_ms": device_ms(
            lambda: pairwise.pairwise_minlabel(pts, pts, lab, mask, eps), 50,
            ("minlabel_kernel", "pairwise_kernel")),
        "cdist_device_ms": device_ms(
            lambda: (torch.cdist(pts, pts) <= eps).sum(1), 50),
        "pairwise_count_ms": events_ms(
            lambda: pairwise.pairwise_count(pts, pts, eps, 5), 50),
        "cdist_ms": events_ms(
            lambda: (torch.cdist(pts, pts) <= eps).sum(1), 50),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--reps", type=int, default=7)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("walk_ab: no CUDA device")
    port, fdbscan, pointclouds = load_port(a.src)
    out = {"src": a.src, "card": card()}
    print(out["card"], flush=True)
    for dset, n, eps, mp in MAIN:
        out[dset] = scenario(port, fdbscan, pointclouds, dset, n, eps, mp,
                             a.reps)
    out["tiles"] = tiles()
    print("[times] " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
