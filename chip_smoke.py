"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card
(exact equality; the tile kernels at widths from 1 to 64), drives the
port's main path — ``repro_torch.dbscan(..., algorithm="auto")`` — at
full size on two scenarios and on the tiled path at d = 2, 17 and 64,
checks the results against a second backend and a blocked numpy oracle,
and shows that every walk and tile of the main path ran as a kernel.

    python3 chip_smoke.py --profile    # adds a per-kernel time breakdown

Output: one line per phase; then one JSON line with every kernel's launch
count, error against its plain version and timings; and as the last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code 1) before
the last line is printed. Without a CUDA device it exits with code 2 and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device; nothing was run\n")
    sys.exit(2)

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import repro_torch  # noqa: E402
from repro_torch import _build  # noqa: E402
from repro_torch.core import fdbscan, grid, lbvh, traversal  # noqa: E402
from repro_torch.core import validate  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.kernels import pairwise, ref  # noqa: E402
from repro_torch.kernels import traverse as kt, walkpack  # noqa: E402

DEV = torch.device("cuda", 0)
# H100 SXM published peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores; every bound below is against these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# The repo's phase-cost scenarios (benchmarks/bench_phase_cost.py) at full
# scale, eps scaled from n = 16,384 so the neighbourhood size stays the same:
# (dataset, n, eps, min_pts)
MAIN = [("hacc_like", 2_097_152, 0.00595, 5),
        ("portotaxi_like", 1_048_576, 0.00125, 50)]
# kernel-against-plain checks of the walk with synthetic masks: densebox
# indexes of both scenarios at 262,144 points (d = 3 and d = 2), eps scaled
# like the main path's
WALK_CHECK = [("hacc_like", 262_144, 0.0119, 5),
              ("portotaxi_like", 262_144, 0.0025, 50)]
# every specialization of the walk on smaller indexes of both scenarios
WALK_SPEC = [("hacc_like", 16_384, 0.03, 5),
             ("portotaxi_like", 16_384, 0.01, 50)]
# member tests the walk kernel loads together (csrc/walk.cu: kBatch)
WALK_BATCH = 4
TILE_SHAPES = [(1000, 1000), (130, 257), (7, 5), (64, 20000)]
# widths of the tile checks: the compiled bodies (d <= 4), the unfused
# norm (5, 8), 16 and 17 around the old limit of 16, and the windowed norm
# (33, 64); each on uniform points and on boundary-grid points
TILE_DS = (1, 2, 3, 4, 5, 8, 16, 17, 33, 64)
# timed tile shapes (nq, nr, d): the tiled path's, a width above the old
# limit, and the ring path's scale
TILE_TIMED = [(1000, 1000, 2), (1000, 1000, 17), (16384, 16384, 3)]
TILED_N = 1000
# the tiled path beyond the tree backends' d in {2, 3}: (d, eps, min_pts)
# on uniform separated points
TILED_WIDE = [(17, 1.0, 5), (64, 2.6, 5)]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events."""
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


def device_ms(fn, reps: int, name: str | None = None) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up: the summed time of the CUDA kernels the profiler records
    (those whose name holds ``name``, or all), over ``reps``."""
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


def reset_counts() -> None:
    kt.walk.launches = 0
    walkpack.pack_index.builds = 0
    pairwise.pairwise_count.launches = 0
    pairwise.pairwise_minlabel.launches = 0
    traversal.traverse.runs = 0


def counts() -> dict:
    return {"walk": kt.walk.launches,
            "pairwise_count": pairwise.pairwise_count.launches,
            "pairwise_minlabel": pairwise.pairwise_minlabel.launches,
            "plain_walk_runs": traversal.traverse.runs,
            "walk_index_builds": walkpack.pack_index.builds}


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"kernel/plain outputs differ in type or shape: "
              f"{a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        err = max(err, float((a.double() - b.double()).abs().max())
                  if a.numel() else 0.0)
    return err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def separated(n: int, d: int, eps: float, seed: int) -> np.ndarray:
    """Uniform points with no pair within 0.2% of eps^2 of the boundary,
    so the tiled and tree distance forms cannot disagree on a pair."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    while True:
        x = pts.astype(np.float64)
        d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        bad = np.abs(d2 - eps * eps) < 2e-3 * eps * eps
        np.fill_diagonal(bad, False)
        rows = np.unique(np.nonzero(bad)[0])
        if len(rows) == 0:
            return pts
        pts[rows] = rng.uniform(0, 1, size=(len(rows), d)).astype(np.float32)


def same_core_partition(a, b) -> bool:
    core = a.core_mask.cpu().numpy()
    return (np.array_equal(core, b.core_mask.cpu().numpy())
            and validate.same_partition(a.labels.cpu().numpy()[core],
                                        b.labels.cpu().numpy()[core]))


def check_result(res, n: int, what: str) -> None:
    labels = res.labels
    check(labels.shape == (n,) and labels.dtype == torch.int32
          and labels.device.type == "cuda", f"{what}: labels malformed")
    check(res.core_mask.shape == (n,) and res.core_mask.dtype == torch.bool,
          f"{what}: core mask malformed")
    lo, hi = int(labels.min()), int(labels.max())
    check(res.n_clusters > 0 and lo >= -1 and hi == res.n_clusters - 1,
          f"{what}: labels outside [-1, n_clusters)")
    check(bool((labels[res.core_mask] >= 0).all()),
          f"{what}: a core point is labeled noise")


# --------------------------------------------------------------------- #
# phase 1: environment and build                                        #
# --------------------------------------------------------------------- #

def phase_environment() -> None:
    cap = torch.cuda.get_device_capability(0)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        capability=f"{cap[0]}.{cap[1]}", count=torch.cuda.device_count())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    info = _build.build()
    say("build", seconds=f"{time.perf_counter() - t0:.1f}",
        **{name: f"{v['seconds']:.1f}s" for name, v in info.items()})
    for name, v in info.items():
        regs = ptxas_registers(v["log"])
        spills = sum(" 0 bytes spill stores" not in line
                     for line in v["log"].splitlines() if "spill" in line)
        say(f"ptxas:{name}", kernels=len(regs),
            max_registers=max(regs.values()), with_spills=spills)
        say(f"ptxas-registers:{name}", **regs)


def ptxas_registers(log: str) -> dict:
    """Registers per compiled kernel from ``-Xptxas -v`` output, keyed by
    the kernel's template arguments as they appear in its mangled name."""
    out, entry = {}, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            walk = re.search(r"walk_kernelILi(\d)E([if])Li(\d)E", entry)
            tile = re.search(r"\d([a-z]+_kernel)ILi(\d)E", entry)
            plain = re.search(r"\d([a-z][a-z_]*_kernel)", entry)
            if walk:        # walk_kernel<KIND, V, D>
                entry = (f"kind{walk[1]}_{'f32' if walk[2] == 'f' else 'i32'}"
                         f"_d{walk[3]}")
            elif tile:      # count_kernel<D>, minlabel_kernel<D>; 0: any d
                entry = f"{tile[1]}_d{tile[2] if tile[2] != '0' else 'any'}"
            elif plain:
                entry = plain[1]
        for w, nxt in zip(line.split(), line.split()[1:]):
            if nxt == "registers,":
                out[entry] = int(w)
    return out


# --------------------------------------------------------------------- #
# phase 2: each kernel against its plain version, exact equality        #
# --------------------------------------------------------------------- #

def _walk_cases(segs, tree, eps, mp):
    """(name, predicate, visitor, kwargs) of the three visitor kinds, in
    the shapes the clustering phases give the walk."""
    n = segs.n_points
    g = torch.Generator(device="cpu").manual_seed(0)
    idx = torch.arange(n, dtype=torch.int32, device=DEV)
    vals0 = fdbscan._unify_dense(idx, segs)
    every = traversal.intersects(traversal.sphere(eps))
    # the fused first pass, as fdbscan._fused_first_pass runs it
    first = ("countminlabel", every,
             traversal.CountMinLabelVisitor(
                 vals0, torch.ones(n, dtype=torch.bool, device=DEV),
                 cap=mp - 1), {})
    # a split first sweep: compacted ids with inert -1 lanes at the end, a
    # node mask, and wide lanes that swap in the wide node and gather masks
    active = (torch.rand(n, generator=g) < 0.4).to(DEV)
    ids = torch.cat([fdbscan._compact_ids(active),
                     torch.full((1000,), -1, dtype=torch.int32, device=DEV)])
    wide_pt = (torch.rand(n, generator=g) < 0.1).to(DEV)
    lane_wide = torch.where(ids >= 0, wide_pt[torch.clamp_min(ids, 0)],
                            False)
    narrow = (torch.rand(n, generator=g) < 0.2).to(DEV)
    leaf = (torch.rand(segs.n_segments, generator=g) < 0.3).to(DEV)
    sweep = ("minlabel", traversal.intersects(traversal.sphere(eps), ids=ids),
             traversal.MinLabelVisitor(vals0, narrow,
                                       mask_wide=torch.ones_like(narrow)),
             dict(node_mask=lbvh.propagate_leaf_flags(tree, leaf),
                  node_mask_wide=torch.ones(2 * segs.n_segments - 1,
                                            dtype=torch.bool, device=DEV),
                  wide_lanes=lane_wide))
    # the early-exit count pass over the loose points
    loose = fdbscan._compact_ids(~segs.dense_pt)
    count = ("count", traversal.intersects(traversal.sphere(eps), ids=loose),
             traversal.CountVisitor(cap=mp), {})
    return [first, sweep, count]


def _same_walk(name, k, p) -> float:
    """Exact equality of a kernel walk and a plain walk; the error."""
    e = max_abs_err([(k.acc, p.acc), (k.hits, p.hits),
                     (k.evals, p.evals), (k.iters, p.iters)])
    check(e == 0.0, f"walk {name}: kernel differs from plain "
                    f"(max abs err {e})")
    return e


def _index(dset: str, n: int, eps: float, mp: int):
    pts = torch.from_numpy(pointclouds.load(dset, n)).to(DEV)
    segs = grid.build_segments_densebox(pts, eps, mp)
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    return segs, tree, walkpack.pack_index(tree, segs)


def _check_walk(name, segs, tree, index, pred, cb, kw, unroll=None,
                carry=None):
    """One kernel walk against the plain engine at the same unroll, exact.
    Returns (max abs err, kernel trace)."""
    unroll = kt.PALLAS_UNROLL if unroll is None else unroll
    before = kt.walk.launches
    k = kt.traverse(tree, segs, pred, cb, carry=carry, unroll=unroll,
                    walk_index=index, **kw)
    check(kt.walk.launches - before == int(k.iters.shape[0] > 0),
          f"walk {name}: launches do not match its lanes")
    p = traversal.traverse(tree, segs, pred, cb, carry=carry, unroll=unroll,
                           **kw)
    torch.cuda.synchronize()
    return _same_walk(name, k, p), k


def _spec_matrix(segs, tree):
    """(name, callback, kwargs) of every visitor kind and value type with
    and without the range mask, under each node/gather mask option."""
    n, m = segs.n_points, segs.n_segments
    g = torch.Generator(device="cpu").manual_seed(2)
    vals = {"i32": fdbscan._unify_dense(
        torch.arange(n, dtype=torch.int32, device=DEV), segs),
        "f32": torch.rand(n, generator=g).to(DEV)}
    gather = (torch.rand(n, generator=g) < 0.6).to(DEV)
    wide = (torch.rand(n, generator=g) < 0.3).to(DEV)
    node_mask = lbvh.propagate_leaf_flags(
        tree, (torch.rand(m, generator=g) < 0.5).to(DEV))
    all_nodes = torch.ones(2 * m - 1, dtype=torch.bool, device=DEV)
    nodes = {"none": {}, "node_mask": dict(node_mask=node_mask),
             "node_mask_wide": dict(node_mask=node_mask,
                                    node_mask_wide=all_nodes,
                                    wide_lanes=wide)}
    out = []
    for rng in (False, True):
        r = dict(use_range_mask=True) if rng else {}
        for cap in (5, traversal.INT_MAX):
            for opt, kw in nodes.items():
                out.append((f"count cap={cap} range={rng} {opt}",
                            traversal.CountVisitor(cap=cap), {**kw, **r}))
        for vt, v in vals.items():
            for opt, kw in nodes.items():
                out.append((f"countminlabel {vt} range={rng} {opt}",
                            traversal.CountMinLabelVisitor(v, gather, cap=4),
                            {**kw, **r}))
            for opt, kw in [*nodes.items(),
                            ("mask_wide", dict(wide_lanes=wide)),
                            ("node_mask_wide+mask_wide",
                             nodes["node_mask_wide"])]:
                mw = torch.ones_like(gather) if "mask_wide" in opt else None
                out.append((f"minlabel {vt} range={rng} {opt}",
                            traversal.MinLabelVisitor(v, gather,
                                                      mask_wide=mw),
                            {**kw, **r}))
    return out


def phase_walk_check() -> float:
    """The walk kernel against the plain engine, exact, on densebox
    indexes of both scenarios (d = 3 and d = 2):

    * the three kinds in the clustering phases' shapes at 262,144 points,
      more lanes than the card holds threads, so lanes are refilled;
    * every specialization at 16,384 points: each kind and value type,
      with and without the range mask, with no node mask, a node mask, a
      per-lane wide node mask, and (minlabel) a per-lane wide gather mask;
      count with cap 5 (reached inside a batch of members) and uncapped;
    * lane counts of 1, 31, 33 and 4,099, all lanes inert, and external
      queries with a carry seeded by a first walk;
    * ``iters`` reported at unroll 1 and 7 besides the default 4.

    The main path's own walks are held against the plain engine in
    :func:`phase_main_walk_check`."""
    err = 0.0
    t0 = time.perf_counter()
    for dset, n, eps, mp in WALK_CHECK:
        segs, tree, index = _index(dset, n, eps, mp)
        for name, pred, cb, kw in _walk_cases(segs, tree, eps, mp):
            e, k = _check_walk(f"{dset} {name}", segs, tree, index, pred, cb,
                               kw)
            err = max(err, e)
            say("walk-check", dataset=dset, n=n, d=segs.pts.shape[1],
                kind=name, lanes=int(k.iters.shape[0]),
                threads=kt.walk.last_grid * kt.BLOCK,
                evals=int(k.evals.sum()), iters=int(k.iters.sum()),
                max_abs_err=e)
    for dset, n, eps, mp in WALK_SPEC:
        segs, tree, index = _index(dset, n, eps, mp)
        d = segs.pts.shape[1]
        every = traversal.intersects(traversal.sphere(eps))
        cases = _spec_matrix(segs, tree)
        for name, cb, kw in cases:
            e, _ = _check_walk(f"{dset} {name}", segs, tree, index, every,
                               cb, kw)
            err = max(err, e)
        lens = segs.seg_end - segs.seg_start
        say("walk-spec", dataset=dset, n=n, d=d, cases=len(cases),
            segments=segs.n_segments, members_max=int(lens.max()),
            segments_longer_than_batch=int((lens > WALK_BATCH).sum()),
            max_abs_err=err)
        g = torch.Generator(device="cpu").manual_seed(3)
        vals = torch.arange(n, dtype=torch.int32, device=DEV)
        mask = torch.ones(n, dtype=torch.bool, device=DEV)
        for lanes in (1, 31, 33, 4099):
            ids = torch.randperm(n, generator=g)[:lanes].sort().values.to(
                DEV, torch.int32)
            pred = traversal.intersects(traversal.sphere(eps), ids=ids)
            for cb in (traversal.CountVisitor(cap=mp),
                       traversal.CountMinLabelVisitor(vals, mask, cap=mp - 1)):
                e, _ = _check_walk(f"{dset} {lanes} lanes", segs, tree,
                                   index, pred, cb, {})
                err = max(err, e)
        inert = traversal.intersects(
            traversal.sphere(eps),
            ids=torch.full((100,), -1, dtype=torch.int32, device=DEV))
        e, k = _check_walk(f"{dset} inert", segs, tree, index, inert,
                           traversal.MinLabelVisitor(vals, mask), {})
        check(int(k.iters.sum()) == 0, "inert lanes did work")
        ext = traversal.intersects(
            traversal.sphere(3 * eps),
            pts=torch.rand(137, d, generator=g).to(DEV))
        cb = traversal.MinLabelVisitor(vals, mask)
        e1, k1 = _check_walk(f"{dset} external", segs, tree, index, ext, cb,
                             {})
        e2, _ = _check_walk(f"{dset} external, seeded carry", segs, tree,
                            index, ext, cb, {}, carry=k1.carry)
        err = max(err, e, e1, e2)
        split = next(c for c in cases if c[0] ==
                     "minlabel i32 range=False node_mask_wide+mask_wide")
        for unroll in (1, 7):
            first = traversal.CountMinLabelVisitor(vals, mask, cap=mp - 1)
            for name, cb, kw in (("countminlabel", first, {}), split):
                e, _ = _check_walk(f"{dset} {name} unroll={unroll}", segs,
                                   tree, index, every, cb, kw, unroll=unroll)
                err = max(err, e)
        say("walk-lanes", dataset=dset, n=n, d=d,
            lanes="1,31,33,4099,inert,external+carry", unrolls="1,4,7",
            max_abs_err=err)
    say("walk-check-time", seconds=f"{time.perf_counter() - t0:.1f}")
    return err


WALK_TIMED = {0: "first pass", 1: "first sweep"}


def _walk_timing(dset, label, args, kw, plain_ms: float) -> dict:
    """Kernel time, bound and counters of one of the main path's walks,
    on its own index, lanes and visitor."""
    tree, segs, pred, cb = args
    ms = cuda_ms(lambda: kt.traverse(*args, **kw), 5)
    n, d = segs.pts.shape
    k = kt.traverse(*args, **kw)
    L = int(k.iters.shape[0])
    in_bytes = nbytes(segs.pts, segs.seg_start, segs.seg_end, segs.dense_seg,
                      tree.left, tree.miss, tree.box_lo, tree.box_hi,
                      getattr(cb, "vals", None), getattr(cb, "mask", None),
                      getattr(cb, "mask_wide", None), kw.get("node_mask"),
                      kw.get("node_mask_wide"))
    # lane arrays (q, qid, self_id, rank, dense, wide, acc0, hits0) and the
    # four outputs
    lane_bytes = L * (4 * d + 4 * 3 + 1 * 2 + 4 * 2) + L * 4 * 4
    # at unroll 1 every loop trip is one work unit, so trips minus member
    # tests counts the node visits this data needs
    k1 = kt.traverse(*args, **{**kw, "unroll": 1})
    check(bool(torch.equal(k1.evals, k.evals)), "walk: evals depend on unroll")
    evals = float(k.evals.sum())
    visits = float(k1.iters.sum()) - evals
    # member test: d subs, squares as 1 mul + (d-1) fmas, 1 compare (3d);
    # node test: 2d subs, 2d maxes, 2d - 1 for the squares, 1 compare (6d)
    ops = evals * 3 * d + visits * 6 * d
    b_ms, b_by = bound(in_bytes + lane_bytes, ops)
    say("walk-time", dataset=dset, walk=repr(label), n=n, d=d, lanes=L,
        kind=type(cb).__name__, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.2f}",
        bound_ms=f"{b_ms:.5f}", bound_by=b_by, member_tests=int(evals),
        node_visits=int(visits), bytes=in_bytes + lane_bytes,
        grid=kt.walk.last_grid, block=kt.BLOCK)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def phase_main_walk_check(runs) -> tuple[float, dict]:
    """Replay each full-size scenario's clustering run with some of its
    walks also run by the plain engine on the same inputs, exact equality:
    the fused first pass, the first two sweeps (the split first sweep and a
    frontier sweep over compacted lanes) and the border gather. The first
    pass and first sweep of each scenario are also timed; the first
    scenario's first pass is the walk kernel's time in the kernel table.
    Runs after the counted main path, so neither engine's runs here enter
    the launch counts."""
    err, timing = 0.0, {}
    for dset, n, eps, mp, pts, plan, _, _ in runs:
        if plan is None:
            continue
        before = kt.walk.launches
        repro_torch.dbscan(pts, eps, mp, query_plan=plan)
        n_walks = kt.walk.launches - before
        picks = {0, 1, 2, n_walks - 1}
        calls = []

        def checked(*args, **kw):
            nonlocal err
            i = len(calls)
            calls.append(i)
            k = kt.traverse(*args, **kw)
            if i not in picks:
                return k
            plain_kw = {key: v for key, v in kw.items() if key != "walk_index"}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p = traversal.traverse(*args, unroll=kt.PALLAS_UNROLL, **plain_kw)
            end.record()
            torch.cuda.synchronize()
            name = type(args[3]).__name__
            e = _same_walk(f"{dset} call {i} ({name})", k, p)
            err = max(err, e)
            plain_ms = start.elapsed_time(end)
            say("walk-check", dataset=dset, n=n, call=f"{i}/{n_walks}",
                kind=name, lanes=int(k.iters.shape[0]),
                node_mask=kw.get("node_mask") is not None,
                wide_lanes=int(kw["wide_lanes"].sum())
                if kw.get("wide_lanes") is not None else 0,
                evals=int(k.evals.sum()), iters=int(k.iters.sum()),
                plain_s=f"{plain_ms / 1e3:.1f}", max_abs_err=e)
            if i in WALK_TIMED:
                timing[(dset, i)] = _walk_timing(dset, WALK_TIMED[i], args,
                                                 kw, plain_ms)
            return k

        fdbscan._walk, walk_fn = checked, fdbscan._walk
        try:
            res = repro_torch.dbscan(pts, eps, mp, query_plan=plan)
        finally:
            fdbscan._walk = walk_fn
        check(len(calls) == n_walks, f"{dset}: {len(calls)} walks in the "
                                     f"checked run, {n_walks} before")
        check(res.n_traversals == n_walks, f"{dset}: {n_walks} walks for "
                                           f"{res.n_traversals} traversals")
    return err, timing[(MAIN[0][0], 0)]


def phase_walk_totals(runs) -> None:
    """Device time of every walk-kernel launch of one more warm run of
    each full-size scenario (torch.profiler), summed."""
    for dset, n, eps, mp, pts, plan, _, _ in runs:
        if plan is None:
            continue
        before = kt.walk.launches
        ms = device_ms(lambda: repro_torch.dbscan(pts, eps, mp,
                                                  query_plan=plan),
                       1, name="walk_kernel")
        say("walk-total", dataset=dset, n=n,
            launches=(kt.walk.launches - before) // 2,
            walk_device_ms=f"{ms:.4f}")


def tile_eps(x: torch.Tensor, share: float = 0.05) -> float:
    """An eps with about ``share`` of the pairs of ``x``'s first 200
    points within it, so every width has hits to check."""
    dist = torch.pdist(x[:200]).sort().values
    return float(dist[int(share * (dist.numel() - 1))])


@contextlib.contextmanager
def forced_split(split: int):
    """Make the tile wrappers launch with ``split`` warps a query."""
    choose = pairwise.warps_per_query
    pairwise.warps_per_query = lambda *_: split
    try:
        yield
    finally:
        pairwise.warps_per_query = choose


def _same_tiles(q, r, lab, mask, eps, what: str) -> tuple[float, float]:
    """Both tile kernels against their plain versions on one input (count
    at cap 5 and uncapped), exact, at every number of warps a query in
    ``pairwise.SPLITS``, not only the one the wrapper picks; the two
    errors."""
    caps = (5, ref.INT_MAX)
    plain = [ref.pairwise_count_ref(q, r, eps, cap) for cap in caps]
    pl_, pc = ref.pairwise_minlabel_ref(q, r, lab, mask, eps)
    e = e2 = 0.0
    for split in pairwise.SPLITS:
        with forced_split(split):
            got = [pairwise.pairwise_count(q, r, eps, cap) for cap in caps]
            kl, kc = pairwise.pairwise_minlabel(q, r, lab, mask, eps)
        e = max(e, max_abs_err(zip(got, plain)))
        check(e == 0.0, f"pairwise_count {what} split={split}: kernel "
                        f"differs from plain ({e})")
        e2 = max(e2, max_abs_err([(kl, pl_), (kc, pc)]))
        check(e2 == 0.0, f"pairwise_minlabel {what} split={split}: kernel "
                         f"differs from plain ({e2})")
    return e, e2


def grid_points(n: int, d: int, g) -> tuple[torch.Tensor, float]:
    """n points on a grid of step 0.1 with 1e-7 jitter, and an eps on one of
    its distance shells, so many pairs lie at eps and the ulps around it
    (the boundary data of tests/test_torch_pairwise.py): 12 levels and eps
    0.3 at d <= 3; above, the levels {0, 0.1, 0.2} and eps 0.1 * sqrt(k),
    k the median squared grid distance among the first 300 points."""
    levels = 12 if d <= 3 else 3
    cells = torch.randint(0, levels, (n, d), generator=g)
    jitter = torch.rand(n, d, generator=g, dtype=torch.float64) * 2e-7 - 1e-7
    pts = (cells * 0.1 + jitter).to(torch.float32).to(DEV)
    if d <= 3:
        return pts, 0.3
    c = cells[:300]
    k = ((c[:, None] - c[None]) ** 2).sum(-1).double().median()
    return pts, 0.1 * float(k.sqrt())


def _tile_edges(g) -> float:
    """Minlabel's edge cases against the plain version and the expected
    values: every mask zero; one query against one reference, within eps
    and not; labels at INT_MAX - 1."""
    err = 0.0
    for d in (2, 17):
        x = torch.rand(1000, d, generator=g).to(DEV)
        eps = tile_eps(x)
        lab = torch.arange(1000, dtype=torch.int32, device=DEV)
        none = torch.zeros(1000, dtype=torch.bool, device=DEV)
        kl, kc = pairwise.pairwise_minlabel(x, x, lab, none, eps)
        check(bool((kl == ref.INT_MAX).all()) and bool((kc == 0).all()),
              f"minlabel d={d}: hits with every mask zero")
        err = max(err, *_same_tiles(x, x, lab, none, eps, f"d={d} mask 0"))
        one = x[:1]
        for r, want in ((one, (7, 1)), (one + 10 * eps, (ref.INT_MAX, 0))):
            lab1 = torch.full((1,), 7, dtype=torch.int32, device=DEV)
            mask1 = torch.ones(1, dtype=torch.bool, device=DEV)
            kl, kc = pairwise.pairwise_minlabel(one, r, lab1, mask1, eps)
            got = (int(kl[0]), int(kc[0]))
            check(got == want, f"minlabel d={d}, 1 x 1: got {got}, want "
                               f"{want}")
            err = max(err, *_same_tiles(one, r, lab1, mask1, eps,
                                        f"d={d} 1 x 1"))
        big = torch.full((1000,), ref.INT_MAX - 1, dtype=torch.int32,
                         device=DEV)
        every = torch.ones(1000, dtype=torch.bool, device=DEV)
        kl, kc = pairwise.pairwise_minlabel(x, x, big, every, eps)
        check(bool((kl == ref.INT_MAX - 1).all()),
              f"minlabel d={d}: labels at INT_MAX - 1 not kept")
        err = max(err, *_same_tiles(x, x, big, every, eps,
                                    f"d={d} labels INT_MAX - 1"))
    return err


def _tile_timing(nq: int, nr: int, d: int, g) -> dict:
    """Both tile kernels timed at one shape: CUDA events around the
    wrapper, device time (torch.profiler), the plain version, and beside
    them a PyTorch reference point. Returns per kernel the kernel-table
    fields and the device time."""
    x = torch.rand(max(nq, nr), d, generator=g).to(DEV)
    q, r = x[:nq], x[:nr]
    eps = tile_eps(x, 0.01)
    lab = torch.arange(nr, dtype=torch.int32, device=DEV)
    mask = torch.ones(nr, dtype=torch.bool, device=DEV)
    reps = 50 if nq * nr <= 10**7 else 5
    # per pair: the dot product (1 mul, d - 1 fmas as 2 ops each), the
    # distance (add, mul, sub) and the compare; per point its norm
    flops = nq * nr * (2 * d + 3) + (nq + nr) * (2 * d - 1)
    out = {}
    for name, fn, plain, other, other_name, n_bytes, ops in (
            ("pairwise_count",
             lambda: pairwise.pairwise_count(q, r, eps, 5),
             lambda: ref.pairwise_count_ref(q, r, eps, 5),
             lambda: (torch.cdist(q, r) <= eps).sum(1), "library",
             nbytes(q, r) + 4 * nq, flops),
            ("pairwise_minlabel",
             lambda: pairwise.pairwise_minlabel(q, r, lab, mask, eps),
             lambda: ref.pairwise_minlabel_ref(q, r, lab, mask, eps),
             lambda: torch.where((torch.cdist(q, r) <= eps) & mask, lab,
                                 ref.INT_MAX).amin(1), "composite",
             nbytes(q, r, lab, mask) + 8 * nq, flops + nq * nr)):
        ms = cuda_ms(fn, reps)
        dev = device_ms(fn, reps, name.split("_")[1] + "_kernel")
        plain_ms = cuda_ms(plain, 2)
        other_ms = cuda_ms(other, reps)
        other_dev = device_ms(other, reps)
        b_ms, b_by = bound(n_bytes, ops)
        # count: one PyTorch call computes the same function (the library
        # yardstick); minlabel: none does, so the composite of several
        # calls is a reference point only and its library cell stays null
        out[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=other_ms if other_name == "library" else None,
            device_ms=dev)
        say("tile-time", kernel=name, nq=nq, nr=nr, d=d, eps=f"{eps:.5f}",
            split=pairwise.warps_per_query(nq, nr, d), ms=f"{ms:.4f}",
            device_ms=f"{dev:.4f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{b_ms:.5f}", bound_by=b_by,
            **{f"{other_name}_ms": f"{other_ms:.4f}",
               f"{other_name}_device_ms": f"{other_dev:.4f}"})
    return out


def phase_tile_check() -> dict:
    """The tile kernels against their plain versions, exact, at every
    width of ``TILE_DS`` over ``TILE_SHAPES`` on uniform and boundary-grid
    points, at every number of warps a query, minlabel's edge cases and
    the empty query set; then their times at ``TILE_TIMED``. Returns the
    kernel-table fields at the tiled path's shape (the first)."""
    g = torch.Generator(device="cpu").manual_seed(1)
    errs = {"pairwise_count": 0.0, "pairwise_minlabel": 0.0}
    for nq, nr in TILE_SHAPES:
        for d in TILE_DS:
            x = torch.rand(nq + nr, d, generator=g).to(DEV)
            data = [("uniform", x, tile_eps(x)),
                    ("grid", *grid_points(nq + nr, d, g))]
            for kind, x, eps in data:
                q, r = x[:nq], x[nq:]
                lab = torch.randint(0, 1 << 20, (nr,), generator=g,
                                    dtype=torch.int32).to(DEV)
                mask = (torch.rand(nr, generator=g) < 0.6).to(DEV)
                e, e2 = _same_tiles(q, r, lab, mask, eps,
                                    f"{kind} {nq}x{nr} d={d}")
                errs["pairwise_count"] = max(errs["pairwise_count"], e)
                errs["pairwise_minlabel"] = max(errs["pairwise_minlabel"],
                                                e2)
                hits = ref.pairwise_count_ref(q, r, eps).double().mean()
                say("tile-check", data=kind, nq=nq, nr=nr, d=d,
                    eps=f"{eps:.4f}", mean_hits=f"{float(hits):.1f}",
                    splits=",".join(map(str, pairwise.SPLITS)),
                    picked=pairwise.warps_per_query(nq, nr, d),
                    max_abs_err=max(e, e2))
    e = _tile_edges(g)
    errs["pairwise_minlabel"] = max(errs["pairwise_minlabel"], e)
    say("tile-edges", cases="mask 0, 1 x 1 near and far, INT_MAX - 1",
        widths="2,17", max_abs_err=e)
    # no queries: the wrappers return empty results without a launch
    before = (pairwise.pairwise_count.launches,
              pairwise.pairwise_minlabel.launches)
    none = torch.empty(0, 2, device=DEV)
    r = torch.rand(5, 2, generator=g).to(DEV)
    lab = torch.arange(5, dtype=torch.int32, device=DEV)
    got = (pairwise.pairwise_count(none, r, 0.05),
           *pairwise.pairwise_minlabel(none, r, lab, lab > 1, 0.05))
    check(all(t.shape == (0,) and t.dtype == torch.int32 for t in got)
          and before == (pairwise.pairwise_count.launches,
                         pairwise.pairwise_minlabel.launches),
          "a tile wrapper launched or misshaped an empty query set")
    timed = [_tile_timing(nq, nr, d, g) for nq, nr, d in TILE_TIMED]
    return {name: dict(max_abs_err=errs[name],
                       **{k: x for k, x in v.items() if k != "device_ms"})
            for name, v in timed[0].items()}


# --------------------------------------------------------------------- #
# phases 3 and 4: the main path                                         #
# --------------------------------------------------------------------- #

def run_main_path():
    """Drive repro_torch.dbscan(algorithm="auto") on the two full-size
    scenarios and on the tiled path. Returns the results and the plans."""
    out = []
    for dset, n, eps, mp in MAIN:
        pts = pointclouds.load(dset, n)
        before = kt.walk.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = repro_torch.plan(pts, eps, mp, device=DEV)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        res = repro_torch.dbscan(pts, eps, mp, query_plan=plan)   # cold
        warm = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        warm.record()
        res = repro_torch.dbscan(pts, eps, mp, query_plan=plan)
        done.record()
        torch.cuda.synchronize()
        cluster_ms = warm.elapsed_time(done)
        say("main", dataset=dset, n=n, eps=eps, min_pts=mp,
            backend=res.backend, index=plan.stats.get("reason"),
            index_build_s=f"{build_s:.3f}", cluster_ms=f"{cluster_ms:.1f}",
            walk_index_mb=f"{nbytes(*plan.walk_index) / 2**20:.1f}",
            n_clusters=res.n_clusters, n_sweeps=res.n_sweeps,
            walk_launches=kt.walk.launches - before)
        out.append((dset, n, eps, mp, pts, plan, res, cluster_ms))
    for d, eps, mp in [(2, 0.05, 5), *TILED_WIDE]:
        pts = separated(TILED_N, d, eps, seed=3)
        before = (pairwise.pairwise_count.launches,
                  pairwise.pairwise_minlabel.launches)
        res = repro_torch.dbscan(pts, eps, mp)
        torch.cuda.synchronize()
        launched = (pairwise.pairwise_count.launches - before[0],
                    pairwise.pairwise_minlabel.launches - before[1])
        say("tiled", n=TILED_N, d=d, eps=eps, min_pts=mp,
            backend=res.backend, n_clusters=res.n_clusters,
            core=int(res.core_mask.sum()), count_launches=launched[0],
            minlabel_launches=launched[1])
        check(min(launched) > 0, f"tiled d={d}: a tile kernel never ran")
        out.append((f"separated_d{d}", TILED_N, eps, mp, pts, None, res,
                    None))
    return out


def check_main_path(runs, seen: dict) -> None:
    check(seen["walk"] > 0, "the walk kernel never ran on the main path")
    check(seen["plain_walk_runs"] == 0,
          f"the plain walk ran {seen['plain_walk_runs']} times on the card")
    n_plans = sum(plan is not None for *_, plan, _, _ in runs)
    check(seen["walk_index_builds"] == n_plans,
          f"{seen['walk_index_builds']} packed layouts built for {n_plans} "
          f"indexes: clustering with a plan must pack none")
    check(seen["pairwise_count"] > 0 and seen["pairwise_minlabel"] > 0,
          "a tile kernel never ran on the tiled path")
    for dset, n, eps, mp, pts, plan, res, _ in runs:
        check_result(res, n, dset)
        if plan is None:
            d = pts.shape[1]
            check(res.backend == "tiled", f"auto picked {res.backend} at "
                                          f"n={n} d={d}, expected tiled")
            vs = "numpy oracle"
            if d in (2, 3):     # the tree backends take d in {2, 3} only
                other = repro_torch.dbscan(pts, eps, mp,
                                           algorithm="pallas-tree")
                check(same_core_partition(res, other),
                      "tiled result differs from the walk kernel's")
                vs = "pallas-tree + numpy oracle"
            validate.check_dbscan(pts, eps, mp, res.labels.cpu().numpy(),
                                  res.core_mask.cpu().numpy())
            say("check", path=f"tiled d={d}", vs=vs, ok=True)
            continue
        check(res.backend == "pallas-tree",
              f"{dset}: auto resolved to {res.backend} on the card")
        other = repro_torch.dbscan(pts, eps, mp, algorithm="fdbscan")
        torch.cuda.synchronize()
        check(same_core_partition(res, other),
              f"{dset}: auto result differs from the fdbscan index's")
        say("check", path=dset, vs="fdbscan index", ok=True,
            core=int(res.core_mask.sum()), n_clusters=res.n_clusters)
    # a small input held against the blocked numpy oracle
    small = pointclouds.load("hacc_like", 4096, seed=5)
    res = repro_torch.dbscan(small, 0.03, 5)
    check(res.backend == "pallas-tree", "small auto run left the kernel")
    validate.check_dbscan(small, 0.03, 5, res.labels.cpu().numpy(),
                          res.core_mask.cpu().numpy())
    say("check", path="hacc_like n=4096", vs="numpy oracle", ok=True)


def phase_degenerate() -> None:
    """The degenerate parameter matrix on the card, every backend: results
    must be the expected all-noise, one-cluster or two-group labelings and
    pass the numpy oracle."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (60, 2)).astype(np.float32)
    dup = np.tile(pts[:1], (20, 1))
    cases = [("minpts_gt_n", pts, 0.1, 100, 0),
             ("eps_gt_bbox", pts, 50.0, 5, 1),
             ("n1_minpts1", pts[:1], 0.1, 1, 1),
             ("n1_minpts2", pts[:1], 0.1, 2, 0), ("all_dup", dup, 0.1, 5, 1),
             ("all_dup_minpts_gt_n", dup, 0.1, 21, 0)]
    for name, x, eps, mp, want in cases:
        for algorithm in ("auto", "fdbscan", "fdbscan-densebox", "tiled",
                          "pallas-tree"):
            res = repro_torch.dbscan(x, eps, mp, algorithm=algorithm)
            labels = res.labels.cpu().numpy()
            core = res.core_mask.cpu().numpy()
            check(res.n_clusters == want
                  and (labels == (-1 if want == 0 else 0)).all()
                  and (core == (want == 1)).all(),
                  f"degenerate {name} with {algorithm}: {res}")
            validate.check_dbscan(x, eps, mp, labels, core)
    # two tight groups, every point core: the border gather (and with the
    # densebox index the first sweep) has no lanes, so the walk wrapper
    # returns without a launch and counts none
    two = np.concatenate([rng.uniform(0, 0.01, (20, 2)),
                          rng.uniform(0.5, 0.51, (20, 2))]).astype(np.float32)
    lanes = []

    def recorded(*args, **kw):
        tr = walk_fn(*args, **kw)
        lanes.append(int(tr.iters.shape[0]))
        return tr

    fdbscan._walk, walk_fn = recorded, fdbscan._walk
    try:
        for algorithm in ("fdbscan", "fdbscan-densebox", "pallas-tree"):
            lanes.clear()
            before = kt.walk.launches
            res = repro_torch.dbscan(two, 0.1, 5, algorithm=algorithm)
            launched = kt.walk.launches - before
            check(res.n_clusters == 2 and bool(res.core_mask.all())
                  and 0 in lanes
                  and launched == sum(k > 0 for k in lanes),
                  f"all-core run with {algorithm}: {res}, lanes per walk "
                  f"{lanes}, {launched} launches")
            validate.check_dbscan(two, 0.1, 5, res.labels.cpu().numpy(),
                                  res.core_mask.cpu().numpy())
    finally:
        fdbscan._walk = walk_fn
    say("degenerate", cases=len(cases) + 1, backends=5, ok=True)


def phase_profile(runs) -> None:
    """Where the time of one warm clustering run goes on the card: device
    time by kernel (torch.profiler, CUDA activity) of one more warm run.
    The profiler slows the host side of the run, so the idle share is
    taken against the unprofiled warm run's time (``cluster_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):   # tracer start-up
        torch.ones(1, device=DEV).add_(1)
        torch.cuda.synchronize()
    for dset, n, eps, mp, pts, plan, _, cluster_ms in runs:
        if plan is None:
            continue
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            repro_torch.dbscan(pts, eps, mp, query_plan=plan)
            torch.cuda.synchronize()
        kern = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kern.setdefault(e.name, [0.0, 0])
                kern[e.name][0] += e.time_range.elapsed_us() / 1e3
                kern[e.name][1] += 1
        busy = sum(v[0] for v in kern.values())
        walk_ms = sum(v[0] for k, v in kern.items() if "walk_kernel" in k)
        say("profile", dataset=dset, cluster_ms=f"{cluster_ms:.1f}",
            device_busy_ms=f"{busy:.1f}",
            idle_share=f"{1 - busy / cluster_ms:.3f}",
            walk_kernel_ms=f"{walk_ms:.1f}",
            walk_share_of_busy=f"{walk_ms / busy:.3f}",
            device_ops=sum(v[1] for v in kern.values()))
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
        for name, (ms, calls) in top:
            say("profile-kernel", dataset=dset, ms=f"{ms:.2f}", calls=calls,
                share=f"{ms / busy:.3f}", name=repr(name[:60]))


def main() -> None:
    profile_run = "--profile" in sys.argv[1:]
    phase_environment()
    walk_err = phase_walk_check()
    tile_t = phase_tile_check()

    reset_counts()
    runs = run_main_path()
    seen = counts()
    say("counts", **seen)
    check_main_path(runs, seen)
    main_err, walk_t = phase_main_walk_check(runs)
    walk_t["max_abs_err"] = max(walk_err, main_err)
    phase_walk_totals(runs)
    phase_degenerate()
    if profile_run:
        phase_profile(runs)

    csrc = "src/repro_torch/csrc"
    kernels = [
        dict(name="walk", route="cuda", source=f"{csrc}/walk.cu",
             replaces="src/repro/kernels/traverse.py:98",
             launches=seen["walk"], **walk_t),
        dict(name="pairwise_count", route="cuda",
             source=f"{csrc}/pairwise.cu",
             replaces="src/repro/kernels/pairwise.py:67",
             launches=seen["pairwise_count"], **tile_t["pairwise_count"]),
        dict(name="pairwise_minlabel", route="cuda",
             source=f"{csrc}/pairwise.cu",
             replaces="src/repro/kernels/pairwise.py:81",
             launches=seen["pairwise_minlabel"],
             **tile_t["pairwise_minlabel"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
