"""Time the PyTorch/CUDA port's walks on one GPU, to compare two trees.

    python3 tools/walk_ab.py --src PATH/TO/src [--reps 7] [--only tiles]

Imports ``repro_torch`` from ``--src`` (this tree's ``src``, or that of
another checkout, such as the parent commit unpacked by ``git archive``)
and drives the main path at the full sizes of ``chip_smoke.py``:
``hacc_like`` at 2,097,152 points and ``portotaxi_like`` at 1,048,576.
For each: the plan, one cold run, then ``--reps`` warm runs. In every warm
run CUDA events time the first pass and the first sweep (the run's walks 0
and 1) and the whole run; one more warm run under ``torch.profiler`` sums
the walk kernel's device time over all its launches (``walk_device_ms``)
and the device time of every kernel, copy and memset of the run
(``busy_device_ms``).

It also times the two tile kernels at five shapes (``TILE_SHAPES``: the
tiled path's 1000 x 1000 at d = 2 and 3, the same at d = 17, and 16,384 x
16,384 at d = 2 and 3, the ring path's scale): device time and CUDA events
around the wrapper, and beside them ``(cdist(q, r) <= eps).sum(1)`` for
the count and ``where((cdist(q, r) <= eps) & mask, labels,
INT_MAX).amin(1)`` for the min-label (a reference point: no one PyTorch
call computes it). Where the tree chooses how many warps share a query
(``kernels.pairwise.warps_per_query``), every choice is timed too. Last,
the tiled path itself (``dbscan`` on 1,000 uniform points, d = 2 and 17):
the median warm time of ``--reps`` runs (CUDA events) and the device busy
time of one more. A shape or width the tree refuses is reported with its
error. ``--only tiles`` skips the walk scenarios and the k-NN kernel.

It times the k-NN kernel (``kernels.knn.traverse`` on the fdbscan index,
``KNN_SHAPES``): all 2,097,152 hacc lanes at k = 16, all 1,048,576 porto
lanes at k = 8, and 4,096 hacc points as external queries at k = 16,
capped at eps (the kernel table's shape) and unbounded. For each: CUDA
events around the launch (median of ``--reps``, fewer for the full sets),
work units a second (node visits plus member tests: the lanes' ``iters``
at unroll 1), and a digest of ids, d2, evals and iters. ``--only knn``
times only these. ``--out FILE`` writes the result; ``--expect FILE``
(another tree's ``--out``) exits 1 unless every k-NN digest equals that
file's, so parent and change are held equal as they are timed.

``--only tune`` times the tuner's schedules on the two walk scenarios:
with a tree that has ``repro_torch.core.tune``, the plan's warm run under
the pin (``off``: block 128, launch order) and under the card's heuristic
with the first pass and sweeps in launch order (``none``) and in depth
order (``depth``, calibrated by a cold run), in turns, ``--reps`` rounds:
``cluster_ms``, the first pass and first sweep (CUDA events), and one
profiled run each for ``walk_device_ms`` and ``busy_device_ms``; then the
first pass alone at every lane tile in both orders (``first_pass_by_tile``,
median of ``--reps``). A tree without the tuner times its default plan
only (``default``), the parent's side of the comparison. Every schedule's
labels are held equal to the first's.

``--only nodeflags`` times the node-flag kernel (``csrc/nodeflags.cu``,
through ``fdbscan._frontier_node_mask``) against the level loop it replaces
on the card (``lbvh.propagate_leaf_flags_by_level`` with the points'
leaves), on the fdbscan index of hacc_like's 2,097,152 points (4,194,303
nodes), under the core mask, a random half of the points and random
frontiers of 256 and 65,536 points: the kernel's device time (memset and
launch, profiler, mean of ``--reps``), CUDA events around either (median of
``--reps``; the loop's include its host reads), the loop's device time,
and the kernel's byte bound (flags, the leaf of each flagged point, the
parent of each set node and the output, at 3.35 TB/s). Exits 1 unless the
two give the same bytes. Needs a tree with the kernel.

Prints the card's name and power limit and one line ``[times] {json}``
with the medians and every sample.

Compare two trees only within one invocation on one card, in turns:
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

MAIN = [("hacc_like", 2_097_152, 0.00595, 5),
        ("portotaxi_like", 1_048_576, 0.00125, 50)]
TIMED = {0: "first_pass_ms", 1: "first_sweep_ms"}
TILE_SHAPES = [(1000, 1000, 2), (1000, 1000, 3), (1000, 1000, 17),
               (16384, 16384, 2), (16384, 16384, 3)]
# the tiled path: (n, d, eps, min_pts) on uniform points
TILED = [(1000, 2, 0.05, 5), (1000, 17, 1.0, 5)]
# the k-NN kernel: (name, dataset, n, k, external queries or None for all
# lanes resident, radius cap or None)
KNN_SHAPES = [("hacc_all_k16", "hacc_like", 2_097_152, 16, None, None),
              ("porto_all_k8", "portotaxi_like", 1_048_576, 8, None, None),
              ("hacc_4096_external_k16_eps", "hacc_like", 2_097_152, 16,
               4096, 0.00595),
              ("hacc_4096_external_k16", "hacc_like", 2_097_152, 16, 4096,
               None)]
INT_MAX = 2**31 - 1
# the node-flag kernel's random frontiers (points)
NODEFLAG_FRONTIERS = (256, 65_536)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int, name=None) -> float:
    """Mean device milliseconds of the CUDA kernels ``fn()`` launches
    (those whose name holds ``name``, or all), over ``reps`` runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (name is None or name in e.name))
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


def _tuned(tune, fp: str, sw: str, lane_tile: int = 128):
    """A TuneState running the kernel in every phase at (lane_tile, 4),
    the first pass in order ``fp``, the sweeps in ``sw``, the border in
    launch order."""
    return tune.TuneState(tune.TunedConfig(
        first_pass=tune.PhaseConfig("pallas", lane_tile, 4, fp),
        sweep=tune.PhaseConfig("pallas", 128, 4, sw),
        border=tune.PhaseConfig("pallas", 128, 4, "none"),
        source="heuristic"))


def tune_scenario(port, fdbscan, pointclouds, dset, n, eps, mp,
                  reps: int) -> dict:
    """The tuner's schedules on one scenario, in turns (see the module
    docstring)."""
    try:
        tune = importlib.import_module("repro_torch.core.tune")
    except ImportError:
        tune = None
    dev = torch.device("cuda", 0)
    pts = pointclouds.load(dset, n)
    timer = WalkTimer(fdbscan)
    plan = port.plan(pts, eps, mp, device=dev)
    if tune is None:
        plans = {"default": plan}
    else:
        plans = {"off": plan._replace(tune=tune.TuneState(tune.PINNED)),
                 "none": plan._replace(tune=_tuned(tune, "none", "none")),
                 "depth": plan._replace(tune=_tuned(tune, "depth", "depth"))}
    first = {}
    for name, p in plans.items():           # cold runs (and calibration)
        res = port.dbscan(pts, eps, mp, query_plan=p)
        first[name] = res
    ref = next(iter(first.values()))
    for name, res in first.items():
        if not (torch.equal(res.labels, ref.labels)
                and torch.equal(res.core_mask, ref.core_mask)
                and res.n_sweeps == ref.n_sweeps):
            sys.exit(f"walk_ab: {dset} schedule {name} changed the result")
    samples = {name: {"cluster_ms": [], **{k: [] for k in TIMED.values()}}
               for name in plans}
    for _ in range(reps):
        for name, p in plans.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res, walks = timer.run(
                lambda: port.dbscan(pts, eps, mp, query_plan=p))
            end.record()
            torch.cuda.synchronize()
            samples[name]["cluster_ms"].append(start.elapsed_time(end))
            for k, v in walks.items():
                samples[name][k].append(v)
    out = {}
    for name, p in plans.items():
        def run(p=p):
            return port.dbscan(pts, eps, mp, query_plan=p)
        out[name] = {k: statistics.median(v)
                     for k, v in samples[name].items()}
        out[name].update(walk_device_ms=device_ms(run, 1, "walk_kernel"),
                         busy_device_ms=device_ms(run, 1),
                         samples=samples[name])
    if tune is not None:
        by_tile = {}
        rank = plans["depth"].tune.depth_rank
        for _ in range(reps):
            for lane_tile in tune.TUNE_LANE_TILES:
                for order in ("none", "depth"):
                    st = _tuned(tune, order, "none", lane_tile)
                    st.depth_rank = rank
                    p = plan._replace(tune=st)
                    _, walks = timer.run(
                        lambda: port.dbscan(pts, eps, mp, query_plan=p))
                    by_tile.setdefault(f"{lane_tile}/{order}", []).append(
                        walks[TIMED[0]])
        out["first_pass_by_tile"] = {k: statistics.median(v)
                                     for k, v in by_tile.items()}
        out["first_pass_by_tile_samples"] = by_tile
    return out


def _tile_shape(pairwise, nq: int, nr: int, d: int) -> dict:
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.rand(max(nq, nr), d, generator=g).to("cuda")
    q, r = x[:nq], x[:nr]
    dist = torch.pdist(x[:200]).sort().values    # eps: 1% of pairs within
    eps = float(dist[int(0.01 * (dist.numel() - 1))])
    lab = torch.arange(nr, dtype=torch.int32, device="cuda")
    mask = torch.ones(nr, dtype=torch.bool, device="cuda")
    reps = 50 if nq * nr <= 10**7 else 5

    def count():
        return pairwise.pairwise_count(q, r, eps, 5)

    def minlabel():
        return pairwise.pairwise_minlabel(q, r, lab, mask, eps)

    out = {"eps": eps}
    try:
        out.update(
            count_device_ms=device_ms(count, reps, "count_kernel"),
            minlabel_device_ms=device_ms(minlabel, reps, "minlabel_kernel"),
            count_ms=events_ms(count, reps),
            minlabel_ms=events_ms(minlabel, reps))
    except ValueError as e:     # a width the tree's kernels refuse
        out["refused"] = str(e)
        return out
    out.update(
        cdist_device_ms=device_ms(lambda: (torch.cdist(q, r) <= eps).sum(1),
                                  reps),
        composite_device_ms=device_ms(
            lambda: torch.where((torch.cdist(q, r) <= eps) & mask, lab,
                                INT_MAX).amin(1), reps))
    choose = getattr(pairwise, "warps_per_query", None)
    if choose is not None:
        out["split"] = choose(nq, nr, d)
        out["by_split"] = {}
        try:
            for split in pairwise.SPLITS:
                pairwise.warps_per_query = lambda *_, s=split: s
                out["by_split"][split] = [
                    device_ms(count, reps, "count_kernel"),
                    device_ms(minlabel, reps, "minlabel_kernel")]
        finally:
            pairwise.warps_per_query = choose
    return out


def _tiled_path(port, n: int, d: int, eps: float, mp: int,
                reps: int) -> dict:
    pts = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (n, d)).astype(np.float32)).to("cuda")

    def run():
        return port.dbscan(pts, eps, mp)

    try:
        res = run()                                   # cold
    except ValueError as e:
        return {"refused": str(e)}
    samples = [events_ms(run, 1) for _ in range(reps)]
    return {"backend": res.backend, "n_clusters": res.n_clusters,
            "core": int(res.core_mask.sum()),
            "cluster_ms": statistics.median(samples),
            "busy_device_ms": device_ms(run, 1), "samples": samples}


def tiles(port, reps: int) -> dict:
    pairwise = importlib.import_module("repro_torch.kernels.pairwise")
    out = {f"{nq}x{nr}_d{d}": _tile_shape(pairwise, nq, nr, d)
           for nq, nr, d in TILE_SHAPES}
    for n, d, eps, mp in TILED:
        out[f"tiled_n{n}_d{d}"] = _tiled_path(port, n, d, eps, mp, reps)
    return out


def _digest(tr) -> str:
    h = hashlib.sha256()
    for t in (tr.carry.ids, tr.carry.d2, tr.evals, tr.iters):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def knn(reps: int) -> dict:
    port = importlib.import_module("repro_torch")
    kknn = importlib.import_module("repro_torch.kernels.knn")
    traversal = importlib.import_module("repro_torch.core.traversal")
    pointclouds = importlib.import_module("repro_torch.data.pointclouds")
    out, plans = {}, {}
    for name, dset, n, k, n_ext, r in KNN_SHAPES:
        if dset not in plans:
            p = port.plan(pointclouds.load(dset, n), 0.0, 1,
                          algorithm="fdbscan", device=torch.device("cuda", 0))
            plans[dset] = (p.tree, p.segs, p.walk_index)
        tree, segs, index = plans[dset]
        q = None
        if n_ext is not None:   # chip_smoke.py's queries of the table shape
            g = torch.Generator(device="cpu").manual_seed(9)
            q = segs.pts[torch.randperm(n, generator=g)[:n_ext].to("cuda")]
        pred = traversal.nearest(k, r, pts=q)

        def run(unroll=None):
            return kknn.traverse(tree, segs, pred, unroll=unroll,
                                 walk_index=index)

        tr = run(1)
        units = int(tr.iters.sum())
        shape_reps = reps if n_ext is not None else max(1, reps // 3)
        samples = [events_ms(run, 1) for _ in range(shape_reps)]
        ms = statistics.median(samples)
        out[name] = {"ms": ms, "units": units, "units_per_s": units / ms * 1e3,
                     "evals": int(tr.evals.sum()),
                     "iters_max": int(tr.iters.max()),
                     "schedule": getattr(kknn.walk, "last_schedule", None),
                     "digest": _digest(tr), "samples": samples}
        del tr
    return out


def nodeflags(port, fdbscan, pointclouds, reps: int) -> dict:
    lbvh = importlib.import_module("repro_torch.core.lbvh")
    dev = torch.device("cuda", 0)
    dset, n, eps, mp = MAIN[0]
    plan = port.plan(pointclouds.load(dset, n), eps, mp,
                     algorithm="fdbscan", device=dev)
    tree, segs = plan.tree, plan.segs
    core = fdbscan._fused_first_pass(tree, segs, eps, mp,
                                     walk_index=plan.walk_index)[0]
    g = torch.Generator(device="cpu").manual_seed(5)
    sets = {"core": core, "half": (torch.rand(n, generator=g) < 0.5).to(dev)}
    for k in NODEFLAG_FRONTIERS:
        f = torch.zeros(n, dtype=torch.bool, device=dev)
        f[torch.randperm(n, generator=g)[:k].to(dev)] = True
        sets[f"frontier_{k}"] = f
    nodes = tree.parent.shape[0]
    out = {"dataset": dset, "points": n, "nodes": nodes}
    for name, f in sets.items():
        def kernel(f=f):
            return fdbscan._frontier_node_mask(tree, segs, f)

        def loop(f=f):
            return lbvh.propagate_leaf_flags_by_level(tree, f,
                                                      segs.seg_of_point)

        want = loop()
        if not torch.equal(kernel(), want):
            sys.exit(f"walk_ab: node flags differ from the level loop "
                     f"({name})")
        flagged, set_nodes = int(f.sum()), int(want.sum())
        n_bytes = n + 4 * flagged + 4 * set_nodes + nodes
        out[name] = {
            "flagged": flagged, "set_nodes": set_nodes,
            "kernel_device_ms": device_ms(kernel, reps),
            "kernel_ms": statistics.median(events_ms(kernel, 1)
                                           for _ in range(reps)),
            "loop_ms": statistics.median(events_ms(loop, 1)
                                         for _ in range(reps)),
            "loop_device_ms": device_ms(loop, 1),
            "bytes": n_bytes, "bound_ms": n_bytes / 3.35e9}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--only", choices=["tiles", "knn", "tune", "nodeflags"],
                    help="time only the tile kernels and the tiled path, "
                         "only the k-NN kernel, only the tuner's "
                         "schedules, or only the node-flag kernel")
    ap.add_argument("--out", help="write the result as JSON to this file")
    ap.add_argument("--expect", help="a result of another tree (--out): "
                                     "exit 1 unless the k-NN digests equal")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("walk_ab: no CUDA device")
    port, fdbscan, pointclouds = load_port(a.src)
    out = {"src": a.src, "card": card()}
    print(out["card"], flush=True)
    for dset, n, eps, mp in MAIN if a.only is None else []:
        out[dset] = scenario(port, fdbscan, pointclouds, dset, n, eps, mp,
                             a.reps)
    for dset, n, eps, mp in MAIN if a.only == "tune" else []:
        out[dset] = tune_scenario(port, fdbscan, pointclouds, dset, n, eps,
                                  mp, a.reps)
    if a.only in (None, "tiles"):
        out["tiles"] = tiles(port, a.reps)
    if a.only in (None, "knn"):
        out["knn"] = knn(a.reps)
    if a.only == "nodeflags":
        out["nodeflags"] = nodeflags(port, fdbscan, pointclouds, a.reps)
    print("[times] " + json.dumps(out), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f)
    if a.expect and "knn" in out:
        with open(a.expect) as f:
            want = json.load(f)["knn"]
        differ = [name for name, v in out["knn"].items()
                  if want[name]["digest"] != v["digest"]]
        print(f"[expect] {a.expect}: k-NN outputs "
              f"{'differ in ' + ', '.join(differ) if differ else 'equal'}",
              flush=True)
        if differ:
            sys.exit(1)


if __name__ == "__main__":
    main()
