"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card
(exact equality; the walk at every lane tile and lane order of the tuner;
the tile kernels at widths from 1 to 64; the k-NN walk at k = 1 to 100),
drives the port's main paths at full size — clustering,
``repro_torch.dbscan(..., algorithm="auto")``, on two scenarios and on the
tiled path at d = 2, 17 and 64; neighbor queries, ``repro_torch.neighbors``
``knn`` and ``neighbor_count``, on both scenarios; the streaming index,
``repro_torch.stream_handle``, bootstrapped on the porto scenario with a
window, a WAL and a checkpoint, through inserts, deletes, a merge, a
checkpoint, queries, a snapshot and a restore; the serving plane,
``repro_torch.serve.Server``, with two tenants over the same set under
concurrent inserts and queries, then a restore, and its CLI,
``python -m repro_torch.launch.serve``; the tuned ``pallas-tree`` path on
both scenarios under ``REPRO_TUNE`` = off, heuristic and search; the
distributed path, ``repro_torch.distributed``: the sharded tree path
(``tree_dbscan_sharded``) on the hacc scenario over 8 shards of a local
mesh, the dense ring (``ring_dbscan``) over 8, and both over a gloo group
of two ranks in processes of their own on the one card; the
clustering CLI, ``python -m repro_torch.launch.cluster`` (``ring``
among its algorithms), and the ``gdbscan`` baseline — checks the results
against a second backend and numpy oracles, shows that every walk and tile
of each path ran as a kernel, holds the streaming index and the sharded
path on the card against the same calls on the host at small sizes
(every walk of the sharded runs against the host's), and validates the
metrics and trace of an instrumented clustering run
(``repro_torch.obs``).

    python3 chip_smoke.py --profile    # adds a per-kernel time breakdown

Output: one line per phase; then one JSON line with every kernel's launch
count, error against its plain version and timings; and as the last line
``{"ok": true, "device": {...}}``. Any failure raises (exit code 1) before
the last line is printed. Without a CUDA device it exits with code 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
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
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import knn as kknn, pairwise, ref  # noqa: E402
from repro_torch.kernels import traverse as kt, walkpack  # noqa: E402
from repro_torch.launch import mesh as lmesh, roofline  # noqa: E402

DEV = torch.device("cuda", 0)

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
# member tests the walk kernel loads together (csrc/walk.cu: kBatch), and
# the k-NN kernel (csrc/knn.cu: kBatch)
WALK_BATCH = 4
KNN_BATCH = 4
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
# the neighbor queries' main path on the scenarios of MAIN: (dataset, n, k)
# for knn, and neighbor_count on the first at its eps (resident, and
# external queries with a cap)
NEIGHBORS = [("hacc_like", 2_097_152, 16), ("portotaxi_like", 1_048_576, 8)]
NC_EXTERNAL, NC_CAP = 65_536, 5
# queries of each full-size run held against the numpy oracle
ORACLE_QUERIES = 256
# the k-NN kernel against the plain engine: fdbscan indexes of both
# scenarios and a radius cap for each that leaves some lists short. Small
# indexes: an unbounded walk's length grows with n, and the plain engine
# takes about 2 ms a step on the card (the walk of k = 100 is 3,753 steps
# on hacc at 2,048 points, 11,564 at 16,384), so the long unbounded cases
# run at unroll 4, a quarter of the steps
KNN_CHECK = [("hacc_like", 2_048, 0.06), ("portotaxi_like", 2_048, 0.015)]
# the kernel-table shape of the k-NN kernel: points of the hacc set as
# external queries against its full index at its k, capped at its eps
# (unbounded, the plain engine took 97 s on 4,096 uniform queries there);
# the same queries unbounded are timed beside cdist + topk as a reference
# point
KNN_TIMED_QUERIES = 4096
# resident lanes of the full porto index held against the plain engine at
# its k, capped at its eps (about 1,000 plain steps at unroll 1)
KNN_PORTO_LANES = 256
# the streaming index at full scale: the porto scenario of MAIN as the
# bootstrap set, STREAM_BATCHES inserts of STREAM_BATCH points in a window
# of the bootstrap size (each insert expires the oldest batch), a delete of
# STREAM_DELETE_FRAC of the survivors after every fourth insert, a merge
# after batch STREAM_MERGE_AT and a checkpoint after STREAM_CKPT_AT, and
# STREAM_BATCH probes after each insert (half the next batch, half uniform
# in the bounding box)
STREAM = MAIN[1]
STREAM_BATCH, STREAM_BATCHES = 16_384, 16
STREAM_DELETE_FRAC = 0.01
STREAM_MERGE_AT, STREAM_CKPT_AT = 8, 12
# the streaming index on the card held against the same index on the host
# (the plain engine, no kernel), byte for byte after every op, at small
# sizes (the host walks a trip at a time): (dataset, n, eps, min_pts)
STREAM_PARITY = [("portotaxi_like", 800, 0.015, 20),
                 ("hacc_like", 800, 0.04, 5)]
STREAM_PARITY_BATCH = 120
# the serving plane at the stream run's size: a Server over the porto
# bootstrap set with two tenants (the stream run's eps and min_pts, and one
# coarser), durability files in a temporary directory, SERVE_INSERTS
# batches of SERVE_BATCH next points submitted in turn while SERVE_CLIENTS
# query clients send requests of SERVE_PROBES probes (half jittered
# residents, half uniform) for the whole phase, SERVE_IDLE_S of them after
# the last insert; then one more batch with no client running (the writer
# alone, for comparison), shutdown and Server.restore
SERVE_TENANTS = [("a", 0.00125, 50), ("b", 0.0025, 20)]
SERVE_BATCH, SERVE_INSERTS = 16_384, 8
SERVE_CLIENTS, SERVE_PROBES, SERVE_IDLE_S = 2, (64, 512), 3.0
# replies per tenant held against the same version's snapshot rebuilt on
# the host from the same frozen state
SERVE_SAMPLED = 64
# the serving CLI (python -m repro_torch.launch.serve) on the card
SERVE_CLI_N, SERVE_CLI_STEPS = 262_144, 20
# the reference's golden scenarios (tests/golden/make_golden.py):
# (dataset, n, eps, min_pts); the walk kernel's uncapped counts are held
# against the golden file's
GOLDEN_SCENARIOS = [("ngsim_like", 800, 0.01, 5),
                    ("portotaxi_like", 800, 0.02, 5),
                    ("road3d_like", 800, 0.01, 5),
                    ("hacc_like", 800, 0.05, 5),
                    ("blobs", 800, 0.05, 8)]
# the clustering CLI (python -m repro_torch.launch.cluster) on the card:
# (dataset, n, eps, min_pts), eps scaled like WALK_CHECK's; gdbscan (its
# n x n adjacency) at (n, eps, min_pts) on boundary-separated 3-D points
CLUSTER_CLI = ("hacc_like", 262_144, 0.0119, 5)
CLUSTER_GDBSCAN = (4096, 0.08, 5)
# the distributed path (repro_torch.distributed). [sharded]: the hacc
# scenario at full size on a local mesh of SHARDED_P shards on the card.
SHARDED = MAIN[0]
SHARDED_P = 8
# [sharded-check]: the card's local mesh against the same call on the host
# (the walks' plain versions), uniform points, (d, eps) at min_pts 5 (about
# three neighbours a point: a third of the points core, in some 200 to
# 260 clusters, 6 to 9 sweeps; the host's plain walks are most of the
# phase), at every shard count; and a mesh so wide for its n that its
# last shard holds only sentinel rows: (n, P, eps a d)
SHARDED_CHECK_N = 4096
SHARDED_CHECK = [(2, 0.0153), (3, 0.0559)]
SHARDED_CHECK_P = (1, 2, 3, 8)
SHARDED_WIDE = (100, 16, {2: 0.15, 3: 0.25})
# [ring]: the dense ring at RING_P shards on points of an integer lattice
# (exact distances in every arithmetic form), (n, d, lattice side, eps,
# min_pts): about 4.6 neighbours a point. n = 524,288 ran in 9.2 s (46
# sweeps; H100 80GB HBM3, 700 W); the tiles grow as n^2, so the next
# doubling would take about 37 s, over the phase's 30 s.
RING_P = 8
RING = (524_288, 2, 2048, 3.5, 5)
# [mesh-group]: two ranks of a gloo group on the one card, each in a
# process of its own, against the local mesh at the same shard count; the
# hacc scenario at 65,536 points, eps scaled to keep its neighbourhood
MESH_GROUP = ("hacc_like", 65_536, 0.0189, 5)
MESH_GROUP_RANKS = 2


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


def device_ms(fn, reps: int, name: str | None = None,
              per_call: int | None = None) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up: the summed time of the CUDA kernels the profiler records
    (those whose name holds ``name``, or all), over ``reps``.

    The profiler must record at least ``per_call`` such kernels a call (by
    default as many as it records in a profiled call of its own; a library
    call may launch a few more in one call than in another); a session
    that records fewer has lost some, says so and is taken again, at most
    twice, before this raises. The session waits 50 ms on the host before
    the first call and after the last kernel ends, so no kernel lies near
    the window's edges."""
    from torch.profiler import ProfilerActivity, profile

    def session(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        return [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (name is None or name in e.name)]

    fn()
    torch.cuda.synchronize()
    if per_call is None:
        per_call = len(session(1))
    check(per_call > 0, f"device_ms: the profiler recorded no kernel "
                        f"{name or ''} of a call")
    for _ in range(3):
        us = session(reps)
        if len(us) >= reps * per_call:
            return sum(us) / 1e3 / reps
        say("profiler", name=name, recorded=len(us),
            launched=reps * per_call, retry=True)
    raise RuntimeError(f"chip_smoke: the profiler recorded {len(us)} kernels "
                       f"{name or ''} in {reps} calls, not {reps * per_call}")


class _TimedLib:
    """A kernel library whose launch functions record a CUDA event on the
    current stream (the launches' stream) just before and just after each
    call."""

    def __init__(self, lib, marks: list):
        self._lib, self._marks = lib, marks

    def __getattr__(self, name):
        launch = getattr(self._lib, name)

        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = launch(*args)
            end.record()
            self._marks.append((start, end))
            return err
        return call


def launch_ms(module, fn, reps: int) -> tuple[float, int]:
    """Device milliseconds of the kernel launches ``fn()`` makes through
    ``module``'s kernel library (``module._lib()``), summed and averaged
    over ``reps`` runs after one warm-up, and the launches timed: CUDA
    events around each launch call, so the time is the launch's work on
    the stream (the kernel, and the counter's memset where it has one).
    torch.profiler lost the record of single launches in sessions late in
    a full run (one of the 7 hacc walks, in three sessions in a row), so
    the launches of the port's own kernels are timed so."""
    fn()
    torch.cuda.synchronize()
    load, marks = module._lib, []
    lib = load()
    module._lib = lambda: _TimedLib(lib, marks)
    try:
        for _ in range(reps):
            fn()
    finally:
        module._lib = load
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps, len(marks)


def reset_counts() -> None:
    kt.walk.launches = 0
    kknn.walk.launches = 0
    walkpack.pack_index.builds = 0
    pairwise.pairwise_count.launches = 0
    pairwise.pairwise_minlabel.launches = 0
    traversal.traverse.runs = 0


def counts() -> dict:
    return {"walk": kt.walk.launches,
            "knn": kknn.walk.launches,
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
    """(ms, "bytes" or "operations"): the least time the card could take
    for ``n_bytes`` of memory traffic and ``n_ops`` float32 operations,
    against the H100 SXM's published peaks (``launch.mesh``: HBM rate and
    float32 rate outside the tensor cores) through
    ``launch.roofline.roofline_terms``."""
    t = roofline.roofline_terms(
        {"flops": n_ops, "bytes accessed": n_bytes}, {"total": 0},
        peak_flops=lmesh.PEAK_FLOPS_FP32, hbm_bw=lmesh.HBM_BW,
        ici_bw=lmesh.NVLINK_BW)
    if t["t_memory_s"] >= t["t_compute_s"]:
        return t["t_memory_s"] * 1e3, "bytes"
    return t["t_compute_s"] * 1e3, "operations"


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
        report = ptxas_report(v["log"])
        regs = {e: r["registers"] for e, r in report.items()}
        spills = sum(" 0 bytes spill stores" not in line
                     for line in v["log"].splitlines() if "spill" in line)
        say(f"ptxas:{name}", kernels=len(regs),
            max_registers=max(regs.values()), with_spills=spills)
        say(f"ptxas-registers:{name}", **regs)
        if name == "walk":
            # a body for each bound of 64 to 512 threads a block; the
            # block of 128 (the default lane tile) keeps its registers
            check(len(report) == 40, f"walk: {len(report)} bodies compiled, "
                                     "not 40 (10 bodies x 4 bounds)")
            say("ptxas-walk-b128", **{e[:-5]: r for e, r in regs.items()
                                      if e.endswith("_b128")})
        if name == "knn":
            # each k-NN body: registers, stack frame and spill stores; a
            # register-list body with a stack frame or spills has moved its
            # list to local memory, the cost the design removes
            say("ptxas-knn", **{e: f"{r['registers']}regs/{r['stack']}B"
                                   f"stack/{r['spill_stores']}Bspill"
                                for e, r in report.items()})
            check(len(report) == 8, f"knn: {len(report)} bodies compiled, "
                                    "not 8 (d = 2, 3 x capacity 4, 8, 16, "
                                    "device memory)")
            for e, r in report.items():
                check(e.endswith("_mem") or (r["stack"] == 0
                                            and r["spill_stores"] == 0),
                      f"knn body {e}: {r['stack']} bytes of stack frame, "
                      f"{r['spill_stores']} bytes of spill stores")


def ptxas_report(log: str) -> dict:
    """Registers, stack frame bytes and spill store bytes per compiled
    kernel from ``-Xptxas -v`` output, keyed by the kernel's template
    arguments as they appear in its mangled name."""
    out, entry = {}, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            walk = re.search(r"walk_kernelILi(\d)E([if])Li(\d)ELi(\d+)E",
                             entry)
            tile = re.search(r"\d([a-z]+_kernel)ILi(\d)E", entry)
            knn = re.search(r"knn_kernelILi(\d)ELi(\d+)E", entry)
            plain = re.search(r"\d([a-z][a-z_]*_kernel)", entry)
            if walk:        # walk_kernel<KIND, V, D, MAXB>
                entry = (f"kind{walk[1]}_{'f32' if walk[2] == 'f' else 'i32'}"
                         f"_d{walk[3]}_b{walk[4]}")
            elif knn:       # knn_kernel<D, CAP>; CAP 0: list in memory
                entry = (f"knn_d{knn[1]}_"
                         f"{'mem' if knn[2] == '0' else 'cap' + knn[2]}")
            elif tile:      # count_kernel<D>, minlabel_kernel<D>; 0: any d
                entry = f"{tile[1]}_d{tile[2] if tile[2] != '0' else 'any'}"
            elif plain:
                entry = plain[1]
            out[entry] = dict(registers=0, stack=0, spill_stores=0)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
        if frame and entry in out:
            out[entry]["stack"] = max(out[entry]["stack"], int(frame[1]))
            out[entry]["spill_stores"] = max(out[entry]["spill_stores"],
                                             int(frame[2]))
        for w, nxt in zip(line.split(), line.split()[1:]):
            if nxt == "registers," and entry in out:
                out[entry]["registers"] = int(w)
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
                threads=kt.walk.last_grid * kt.walk.last_block,
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


def _kernel_walk(args, kw):
    """A walk of the main path as it ran: through its phase's engine (the
    ``engine`` keyword of ``fdbscan._walk``), by default the walk entry."""
    rest = {key: v for key, v in kw.items() if key != "engine"}
    return (kw.get("engine") or kt.traverse)(*args, **rest)


def _plain_kw(kw) -> dict:
    """The keyword arguments of a main-path walk that the plain engine
    takes (no engine, packed index, block or lane order: none changes an
    output)."""
    return {key: v for key, v in kw.items()
            if key not in ("engine", "walk_index", "lane_tile", "reorder",
                           "depth_rank", "unroll")}


def _walk_timing(dset, label, args, kw, plain_ms: float) -> dict:
    """Kernel time, bound and counters of one of the main path's walks,
    on its own index, lanes and visitor."""
    tree, segs, pred, cb = args
    ms = cuda_ms(lambda: _kernel_walk(args, kw), 5)
    n, d = segs.pts.shape
    k = _kernel_walk(args, kw)
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
    k1 = _kernel_walk(args, {**kw, "unroll": 1})
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
        grid=kt.walk.last_grid, block=kt.walk.last_block)
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
            k = walk_fn(*args, **kw)
            if i not in picks:
                return k
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p = traversal.traverse(*args,
                                   unroll=kw.get("unroll", kt.PALLAS_UNROLL),
                                   **_plain_kw(kw))
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
    each full-size scenario, summed (:func:`launch_ms`)."""
    for dset, n, eps, mp, pts, plan, _, _ in runs:
        if plan is None:
            continue
        before = kt.walk.launches
        repro_torch.dbscan(pts, eps, mp, query_plan=plan)
        launches = kt.walk.launches - before
        ms, timed = launch_ms(kt, lambda: repro_torch.dbscan(
            pts, eps, mp, query_plan=plan), 1)
        check(timed == launches, f"walk totals: {timed} of {launches} "
                                 "launches timed")
        say("walk-total", dataset=dset, n=n, launches=launches,
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
        dev = device_ms(fn, reps, name.split("_")[1] + "_kernel", 1)
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


# --------------------------------------------------------------------- #
# the k-NN walk kernel and the neighbor queries                          #
# --------------------------------------------------------------------- #

def np_fma(a, b, c):
    """Correctly rounded float32 ``a * b + c`` in numpy: the float64 sum of
    the exact product is rounded to odd, then once to float32."""
    p = a.astype(np.float64) * b.astype(np.float64)
    cd = c.astype(np.float64)
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    bits = s.view(np.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)
    bits = np.where(nudge, np.where(away, bits + 1, bits - 1), bits)
    return bits.view(np.float64).astype(np.float32)


def np_d2(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    """float32 squared distances rounded as the walk rounds them: the first
    axis's square, then one fused multiply-add per axis."""
    diff = (q - p).astype(np.float32)
    out = diff[..., 0] * diff[..., 0]
    for c in range(1, diff.shape[-1]):
        out = np_fma(diff[..., c], diff[..., c], out)
    return out


def _near(q: np.ndarray, pts: np.ndarray, r2: float) -> np.ndarray:
    """Ids whose float64 squared distance to ``q`` is within ``r2`` plus a
    margin above the float32 roundings: a superset of the float32 hits."""
    d64 = np.zeros(len(pts))
    for c in range(pts.shape[1]):
        d64 += (np.float64(q[c]) - pts[:, c].astype(np.float64)) ** 2
    return np.flatnonzero(d64 <= r2 * (1 + 1e-5) + 1e-30), d64


def oracle_knn(pts: np.ndarray, q: np.ndarray, k: int, radius=None):
    """Brute-force k nearest of one query: the stable argsort of its
    float32 distance row (ties to the smaller index), over a candidate set
    chosen in float64 with a margin. Returns (ids, d2), -1/inf padded."""
    d64 = np.zeros(len(pts))
    for c in range(pts.shape[1]):
        d64 += (np.float64(q[c]) - pts[:, c].astype(np.float64)) ** 2
    kk = min(k, len(pts))
    kth = np.partition(d64, kk - 1)[kk - 1]
    cand = np.flatnonzero(d64 <= kth * (1 + 1e-5) + 1e-30)
    d2 = np_d2(q[None, :], pts[cand])
    if radius is not None:
        r32 = np.float32(radius)
        keep = d2 <= r32 * r32
        cand, d2 = cand[keep], d2[keep]
    order = np.lexsort((cand, d2))[:k]
    ids = np.full(k, -1, np.int64)
    dd = np.full(k, np.inf, np.float32)
    ids[:len(order)] = cand[order]
    dd[:len(order)] = d2[order]
    return ids, dd


def oracle_count(pts: np.ndarray, q: np.ndarray, r: float, cap: int) -> int:
    """|N_r(q)| by brute force in the walk's float32 rounding, capped."""
    r32 = np.float32(r)
    cand, _ = _near(q, pts, float(r32) * float(r32))
    d2 = np_d2(q[None, :], pts[cand])
    return min(int((d2 <= r32 * r32).sum()), cap)


def _knn_index(dset: str, n: int):
    pts = torch.from_numpy(pointclouds.load(dset, n)).to(DEV)
    segs = grid.build_segments_fdbscan(pts)
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    return segs, tree, walkpack.pack_index(tree, segs)


def _same_knn(name: str, k, p) -> float:
    """Exact equality of a kernel k-NN walk and a plain one: ids, evals
    and iters equal, d2 bit for bit. Returns the error (0)."""
    e = max_abs_err([(k.carry.ids, p.carry.ids), (k.evals, p.evals),
                     (k.iters, p.iters)])
    same = (k.carry.d2.shape == p.carry.d2.shape
            and torch.equal(k.carry.d2.view(torch.int32),
                            p.carry.d2.view(torch.int32)))
    check(e == 0.0 and same, f"knn {name}: kernel differs from plain "
                             f"(max abs err {e}, d2 bitwise {same})")
    return e


def _check_knn(name, segs, tree, index, pred, unrolls=(1,)):
    """The k-NN kernel against the plain engine at each unroll, exact.
    Returns (error, seconds of plain walks, kernel trace at unroll 1)."""
    err, plain_s, first = 0.0, 0.0, None
    for unroll in unrolls:
        before = kknn.walk.launches
        k = kknn.traverse(tree, segs, pred, unroll=unroll, walk_index=index)
        lanes = int(k.evals.shape[0])
        check(kknn.walk.launches - before == int(lanes > 0),
              f"knn {name}: launches do not match its lanes")
        t0 = time.perf_counter()
        p = traversal.traverse(
            tree, segs, pred,
            traversal.KNNVisitor(pred.k, id_map=segs.order), unroll=unroll)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        err = max(err, _same_knn(f"{name} unroll={unroll}", k, p))
        first = first or k
    return err, plain_s, first


def _knn_refill_grant(dset, segs, tree, index, r, g) -> float:
    """For a register-list body and the device-memory body: as many
    resident lanes (capped at r) as the launch keeps resident threads,
    plus 3, so that full warps refill and the last grant is partly
    filled; held against the plain engine at unroll 1."""
    n, err = segs.n_points, 0.0
    for kk in (kknn.CAPACITIES[-1], kknn.CAPACITIES[-1] + 1):
        probe = torch.zeros(1 << 22, dtype=torch.int32, device=DEV)
        kknn.traverse(tree, segs, traversal.nearest(kk, r, ids=probe),
                      walk_index=index)
        sched = dict(kknn.walk.last_schedule)
        check(sched["warp_lanes"] == 32, f"knn: {1 << 22} lanes ran with "
                                         f"partial warps: {sched}")
        resident = sched["grid"] * sched["block"]
        ids = torch.randint(0, n, (resident + 3,), generator=g).sort().values
        pred = traversal.nearest(kk, r, ids=ids.to(DEV, torch.int32))
        e, plain_s, k = _check_knn(f"{dset} {resident + 3} lanes k={kk} r",
                                   segs, tree, index, pred)
        check(kknn.walk.last_schedule == sched,
              f"knn: {resident + 3} lanes took another schedule: "
              f"{kknn.walk.last_schedule}, not {sched}")
        err = max(err, e)
        say("knn-check", dataset=dset, n=n, case=repr(
            f"resident threads + 3 = {resident + 3} lanes k={kk} r"),
            unrolls=1, **sched, evals=int(k.evals.sum()),
            iters_max=int(k.iters.max()), plain_s=f"{plain_s:.1f}",
            max_abs_err=e)
    return err


def _knn_segments(dset: str, n: int, r: float) -> float:
    """The k-NN kernel's batched member tests: a densebox index of the
    same points (segments of several members), k = 16 (register list)
    resident and unbounded at unroll 1 and 4, k = 17 (list in memory)
    external and capped at r, against the plain engine."""
    pts = torch.from_numpy(pointclouds.load(dset, n)).to(DEV)
    segs = grid.build_segments_densebox(pts, r, 5)
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    index = walkpack.pack_index(tree, segs)
    sizes = segs.seg_end - segs.seg_start
    check(int(sizes.max()) > KNN_BATCH,
          f"the densebox index of {dset} has no segment above a batch")
    g = torch.Generator(device="cpu").manual_seed(5)
    ids = torch.randint(0, n, (1024,), generator=g).sort().values.to(
        DEV, torch.int32)
    ext = torch.rand(1024, pts.shape[1], generator=g).to(DEV)
    err = 0.0
    for name, pred, unrolls in (
            ("1024 lanes k=16", traversal.nearest(16, ids=ids), (1, 4)),
            ("1024 external k=17 r", traversal.nearest(17, r, pts=ext),
             (1,))):
        e, plain_s, k = _check_knn(f"{dset} densebox {name}", segs, tree,
                                   index, pred, unrolls)
        err = max(err, e)
        say("knn-check", dataset=dset, n=n, index="densebox",
            segments=segs.n_segments, max_segment=int(sizes.max()),
            case=repr(name), unrolls=",".join(map(str, unrolls)),
            evals=int(k.evals.sum()), iters_max=int(k.iters.max()),
            plain_s=f"{plain_s:.1f}", max_abs_err=e)
    return err


def phase_knn_check() -> float:
    """The k-NN walk kernel against the plain engine on the card, exact
    (ids and d2 bit for bit, evals, iters at unroll 1 and 4), on fdbscan
    indexes of both scenarios: k = 1, 2, 16 and 100, each with and without
    a radius cap; 1, 31, 33 and 4,099 resident lanes, inert lanes and
    4,096 external lanes; each list body at its capacity and one above
    (k = 4/5, 8/9, 16/17) on resident lanes with inert ones among them and
    on external lanes; resident threads + 3 lanes (a partly filled refill
    grant) for the last register body and the memory body; a densebox
    index of the same points (batched member tests); then on the 7 x 7
    lattice of tests/test_neighbors.py (exact ties) against the plain
    engine and the numpy oracle. The main path's own full-size results
    are held against the plain engine (external lanes, capped) in
    :func:`phase_knn_timing` and against the numpy oracle in
    :func:`check_neighbors`."""
    err = 0.0
    t_all = time.perf_counter()
    for dset, n, r in KNN_CHECK:
        segs, tree, index = _knn_index(dset, n)
        d = segs.pts.shape[1]
        g = torch.Generator(device="cpu").manual_seed(4)

        def ids(lanes):
            # sorted resident ids; more lanes than points repeat ids
            return torch.randint(0, n, (lanes,), generator=g).sort().values.to(
                DEV, torch.int32)

        lanes = ids(4099)
        ext = torch.rand(4096, d, generator=g).to(DEV)
        nearest = traversal.nearest
        cases = [
            ("4099 lanes k=1", nearest(1, ids=lanes), (4,)),
            ("4099 lanes k=16", nearest(16, ids=lanes), (4,)),
            ("1 lane k=100", nearest(100, ids=ids(1)), (4,)),
            ("4099 lanes k=2 r", nearest(2, r, ids=lanes), (1,)),
            ("4099 lanes k=16 r", nearest(16, r, ids=lanes), (1, 4)),
            ("1 lane k=100 r", nearest(100, r, ids=ids(1)), (1,)),
            ("31 lanes k=2", nearest(2, ids=ids(31)), (1,)),
            ("33 lanes k=16 r", nearest(16, r, ids=ids(33)), (1,)),
            ("100 inert lanes k=16", nearest(
                16, ids=torch.full((100,), -1, dtype=torch.int32,
                                   device=DEV)), (1,)),
            ("4096 external k=1 r", nearest(1, r, pts=ext), (1,)),
            ("4096 external k=16", nearest(16, pts=ext), (4,)),
            ("4096 external k=100 r", nearest(100, r, pts=ext), (1,))]
        # each list body at its capacity and one above it (the next body):
        # resident lanes with inert ones among them, unbounded, and
        # external lanes capped at r
        mixed = lanes.clone()
        mixed[::9] = -1
        for cap in kknn.CAPACITIES:
            for kk in (cap, cap + 1):
                cases += [(f"4099 lanes, inert among them, k={kk}",
                           nearest(kk, ids=mixed), (1, 4)),
                          (f"4096 external k={kk} r", nearest(kk, r, pts=ext),
                           (1, 4))]
        for name, pred, unrolls in cases:
            e, plain_s, k = _check_knn(f"{dset} {name}", segs, tree, index,
                                       pred, unrolls)
            err = max(err, e)
            if name.startswith("100 inert"):
                check(int(k.iters.sum()) == 0
                      and bool((k.carry.ids == -1).all()),
                      "inert k-NN lanes did work")
            if "inert among" in name:
                dead = mixed < 0
                check(int(k.iters[dead].sum()) == 0
                      and bool((k.carry.ids[dead] == -1).all())
                      and bool((k.iters[~dead] > 0).all()),
                      "inert k-NN lanes among resident ones did work")
            say("knn-check", dataset=dset, n=n, d=d, case=repr(name),
                unrolls=",".join(map(str, unrolls)),
                body=kknn.walk.last_schedule["capacity"],
                warp_lanes=kknn.walk.last_schedule["warp_lanes"],
                evals=int(k.evals.sum()), iters_max=int(k.iters.max()),
                filled=f"{float((k.carry.ids >= 0).float().mean()):.3f}",
                plain_s=f"{plain_s:.1f}", max_abs_err=e)
        err = max(err, _knn_refill_grant(dset, segs, tree, index, r, g))
        err = max(err, _knn_segments(dset, n, r))
    # the lattice: integer coordinates, so equidistant rings are true ties
    xy = np.stack(np.meshgrid(np.arange(7.0), np.arange(7.0)), -1)
    lat = xy.reshape(-1, 2).astype(np.float32)
    lat = lat[np.random.default_rng(1).permutation(len(lat))]
    segs = grid.build_segments_fdbscan(torch.from_numpy(lat).to(DEV))
    tree = lbvh.build_tree(segs.codes, segs.prim_lo, segs.prim_hi)
    index = walkpack.pack_index(tree, segs)
    sorted_q = segs.pts.cpu().numpy()
    centre = np.array([[3.0, 3.0]], np.float32)
    for k, q in ((2, None), (3, None), (4, None), (6, None), (3, centre)):
        pred = traversal.nearest(
            k, pts=None if q is None else torch.from_numpy(q).to(DEV))
        e, _, kk = _check_knn(f"lattice k={k}", segs, tree, index, pred,
                              (1, 4))
        err = max(err, e)
        qs = sorted_q if q is None else q
        for i, qi in enumerate(qs):
            want, _ = oracle_knn(lat, qi, k)
            check(np.array_equal(kk.carry.ids[i].cpu().numpy(), want),
                  f"lattice k={k} query {i}: kernel ids differ from oracle")
    say("knn-lattice", n=49, ks="2,3,4,6,centre", unrolls="1,4",
        max_abs_err=err)
    say("knn-check-time", seconds=f"{time.perf_counter() - t_all:.1f}")
    return err


class _WeightSum(traversal.Visitor):
    """A user's visitor for ``radius_visit``: sum(weights[j]) over the
    in-radius neighbors, a bare-tensor carry."""

    def __init__(self, weights):
        self.weights = weights

    def init_carry(self, ids, external, segs):
        return torch.zeros(ids.shape, dtype=self.weights.dtype,
                           device=ids.device)

    def visit(self, carry, j, d2, hit, ctx):
        return carry + torch.where(hit, self.weights[j], 0), hit


def _sampled(n: int, seed: int) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(n, ORACLE_QUERIES,
                                                      replace=False))


def run_neighbors():
    """Drive the neighbor queries' main path at full size: ``knn`` on both
    scenarios (cold: with the index build; then warm), ``neighbor_count``
    on hacc resident and on external queries with a cap. Returns the
    results and timings for the checks."""
    out = {}
    for dset, n, k in NEIGHBORS:
        pts = pointclouds.load(dset, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.neighbors.knn(pts, k)           # cold: plans
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = repro_torch.neighbors.knn(pts, k)
        end.record()
        torch.cuda.synchronize()
        out[("knn", dset)] = (pts, k, res, cold_s, start.elapsed_time(end))
    dset, n, eps, _ = MAIN[0]
    pts = pointclouds.load(dset, n)
    ext = np.random.default_rng(6).uniform(0, 1, (NC_EXTERNAL, 3)).astype(
        np.float32)
    for name, kw in (("resident", {}),
                     ("external", dict(query_pts=ext, cap=NC_CAP))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = repro_torch.neighbors.neighbor_count(pts, eps, **kw)
        end.record()
        torch.cuda.synchronize()
        out[("count", name)] = (pts, kw, got, start.elapsed_time(end))
    return out


def check_neighbors(out: dict, seen: dict) -> None:
    """The neighbor path's launches, and its results against the numpy
    oracles on sampled queries."""
    check(seen["knn"] >= 2 * len(NEIGHBORS),
          f"the k-NN kernel ran {seen['knn']} times on the neighbor path")
    check(seen["walk"] >= 2, f"the walk kernel ran {seen['walk']} times for "
                             "neighbor_count")
    check(seen["plain_walk_runs"] == 0, f"the plain walk ran "
          f"{seen['plain_walk_runs']} times on the neighbor path")
    for dset, n, k in NEIGHBORS:
        pts, k, res, cold_s, warm_ms = out[("knn", dset)]
        check(tuple(res.indices.shape) == (n, k)
              and res.indices.dtype == torch.int32
              and res.distances.dtype == torch.float32
              and res.indices.device.type == "cuda", f"knn {dset} malformed")
        rows = _sampled(n, 7)
        got_i = res.indices[torch.from_numpy(rows).to(DEV)].cpu().numpy()
        got_d = res.distances[torch.from_numpy(rows).to(DEV)].cpu().numpy()
        check(not got_d[:, 0].any(),
              f"knn {dset}: a query is not at distance 0 from itself")
        for row, gi, gd in zip(rows, got_i, got_d):
            want_i, want_d2 = oracle_knn(pts, pts[row], k)
            want_d = np.sqrt(want_d2.astype(np.float64)).astype(np.float32)
            check(np.array_equal(gi, want_i)
                  and np.array_equal(gd.view(np.int32), want_d.view(np.int32)),
                  f"knn {dset} query {row}: {gi} {gd} != oracle {want_i} "
                  f"{want_d}")
        say("neighbors", call=f"knn k={k}", dataset=dset, n=n,
            cold_s=f"{cold_s:.3f}", warm_ms=f"{warm_ms:.1f}",
            out_mb=f"{nbytes(*res) / 1e6:.0f}",
            oracle_queries=len(rows), ok=True)
    for name in ("resident", "external"):
        pts, kw, got, ms = out[("count", name)]
        q = kw.get("query_pts", pts)
        cap = kw.get("cap", traversal.INT_MAX)
        check(tuple(got.shape) == (len(q),) and got.dtype == torch.int32,
              f"neighbor_count {name} malformed")
        rows = _sampled(len(q), 8)
        got_np = got.cpu().numpy()
        eps = MAIN[0][2]
        for row in rows:
            want = oracle_count(pts, q[row], eps, cap)
            check(int(got_np[row]) == want,
                  f"neighbor_count {name} query {row}: {got_np[row]} != "
                  f"oracle {want}")
        say("neighbors", call=f"neighbor_count {name}", n=len(pts),
            queries=len(q), r=eps, cap=cap, ms=f"{ms:.1f}",
            mean_count=f"{float(got.double().mean()):.2f}",
            oracle_queries=len(rows), ok=True)


def phase_radius_visit() -> None:
    """``radius_visit`` with a user's visitor on the card: the plain
    engine on the index's device, against a dense numpy oracle on points
    with no pair near the radius."""
    r = 0.03
    pts = separated(4096, 2, r, seed=12)
    w = np.random.default_rng(3).integers(1, 10, size=4096).astype(np.int32)
    p = repro_torch.plan(pts, r, 5, algorithm="fdbscan")
    order = p.segs.order.cpu().numpy()
    runs = traversal.traverse.runs
    tr = repro_torch.neighbors.radius_visit(
        pts, r, _WeightSum(torch.from_numpy(w[order]).to(DEV)))
    check(tr.carry.device.type == "cuda" and traversal.traverse.runs == runs + 1,
          "radius_visit did not run the plain engine on the card")
    got = np.zeros(4096, np.int64)
    got[order] = tr.carry.cpu().numpy()
    x = pts.astype(np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    want = np.where(d2 <= r * r, w[None, :], 0).sum(1)
    check(np.array_equal(got, want), "radius_visit differs from the oracle")
    say("radius-visit", n=4096, r=r, device=tr.carry.device.type,
        evals=int(tr.evals.sum()), ok=True)


def phase_knn_timing(out: dict) -> dict:
    """The k-NN kernel's table row, and the main path's indexes held
    against the plain engine. At full size (all hacc lanes, k as in
    NEIGHBORS): the launch's time, and the bound from the run's own evals
    and node visits. At the table shape (KNN_TIMED_QUERIES points of the
    set as external queries on the full hacc index, capped at its eps):
    CUDA events around the wrapper, device time, the plain engine on the
    same inputs (held equal), and the bound. On the full porto index at
    its k, KNN_PORTO_LANES resident lanes capped at its eps, held against
    the plain engine at unroll 1 and 4. As a reference point, the table
    shape's queries unbounded: the launch's time beside the time of
    ``cdist`` + ``topk`` (CUDA events around the calls; its tie rule
    differs)."""
    dset, n, k = NEIGHBORS[0]
    eps = MAIN[0][2]
    pts = out[("knn", dset)][0]
    p = repro_torch.plan(pts, 0.0, 1, algorithm="fdbscan")
    segs, tree, index = p.segs, p.tree, p.walk_index
    d = segs.pts.shape[1]
    idx_bytes = nbytes(*index, segs.order)
    # bytes a node visit and a member test read: the 32-byte record (and
    # a leaf's end in 3-D); the point and, for a hit, its original id
    visit_b = 32 + (4 if d == 3 else 0)
    test_b = index.pts.shape[1] * 4 + 4

    def bound_of(tr, lanes):
        # member test: d subs, 1 mul + (d-1) fmas, 1 compare (3d); node
        # test: 2d subs, 2d maxes, 2d - 1 for the squares, 1 compare (6d);
        # iters at unroll 1 count every work unit. Bytes: the index records
        # the walks read, each once, at most all of the index; the lanes
        # read once and the outputs written once
        evals = float(tr.evals.sum())
        visits = float(tr.iters.sum()) - evals
        read = min(idx_bytes, visits * visit_b + evals * test_b)
        io = lanes * (4 * d + 4) + lanes * (8 * k + 8)
        return bound(read + io, evals * 3 * d + visits * 6 * d)

    def counters(tr, ms):
        # work units (iters at unroll 1) a second, and the launch's body
        # and schedule
        return dict(member_tests=int(tr.evals.sum()),
                    node_visits=int(tr.iters.sum() - tr.evals.sum()),
                    iters_max=int(tr.iters.max()),
                    units_per_s=f"{float(tr.iters.sum()) / ms * 1e3:.4g}",
                    **kknn.walk.last_schedule)

    # launches of 30 ms to 2 s: timed with CUDA events
    every = traversal.nearest(k)
    full = kknn.traverse(tree, segs, every, unroll=1, walk_index=index)
    full_ms = cuda_ms(lambda: kknn.traverse(tree, segs, every,
                                            walk_index=index), 1)
    fb_ms, fb_by = bound_of(full, n)
    say("knn-time", shape=f"{dset} all {n} lanes k={k}",
        ms=f"{full_ms:.3f}", bound_ms=f"{fb_ms:.5f}", bound_by=fb_by,
        **counters(full, full_ms))
    del full
    # the queries: points of the set (so most lie in halos, where the
    # lists fill within eps), as external lanes
    g = torch.Generator(device="cpu").manual_seed(9)
    q = segs.pts[torch.randperm(n, generator=g)[:KNN_TIMED_QUERIES].to(DEV)]
    capped = traversal.nearest(k, eps, pts=q)
    ms = cuda_ms(lambda: kknn.traverse(tree, segs, capped, walk_index=index),
                 5)
    dev_ms, timed = launch_ms(kknn, lambda: kknn.traverse(
        tree, segs, capped, walk_index=index), 5)
    check(timed == 5, f"knn: {timed} of 5 launches timed")
    k1 = kknn.traverse(tree, segs, capped, unroll=1, walk_index=index)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = traversal.traverse(tree, segs, capped,
                               traversal.KNNVisitor(k, id_map=segs.order),
                               unroll=1)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    e = _same_knn(f"{dset} {KNN_TIMED_QUERIES} external, r = eps", k1, plain)
    b_ms, b_by = bound_of(k1, KNN_TIMED_QUERIES)
    say("knn-time", shape=f"{dset} {KNN_TIMED_QUERIES} external k={k} "
        f"r={eps}", ms=f"{ms:.4f}", device_ms=f"{dev_ms:.4f}",
        plain_ms=f"{plain_ms:.0f}", bound_ms=f"{b_ms:.5f}", bound_by=b_by,
        filled=f"{float((k1.carry.ids >= 0).float().mean()):.3f}",
        max_abs_err=e, **counters(k1, ms))
    # the full porto index: resident lanes at its k, capped at its eps
    pdset, pn, pk = NEIGHBORS[1]
    pp = repro_torch.plan(out[("knn", pdset)][0], 0.0, 1,
                          algorithm="fdbscan")
    lanes = torch.randperm(pn, generator=g)[:KNN_PORTO_LANES].sort().values
    pred = traversal.nearest(pk, MAIN[1][2], ids=lanes.to(DEV, torch.int32))
    pe, plain_s, pk1 = _check_knn(f"{pdset} {KNN_PORTO_LANES} lanes, r = eps",
                                  pp.segs, pp.tree, pp.walk_index, pred,
                                  (1, 4))
    e = max(e, pe)
    say("knn-check", dataset=pdset, n=pn, d=2,
        case=repr(f"{KNN_PORTO_LANES} lanes k={pk} r"), unrolls="1,4",
        evals=int(pk1.evals.sum()), iters_max=int(pk1.iters.max()),
        filled=f"{float((pk1.carry.ids >= 0).float().mean()):.3f}",
        plain_s=f"{plain_s:.1f}", max_abs_err=pe)
    unbounded = traversal.nearest(k, pts=q)
    ub_ms_run = cuda_ms(lambda: kknn.traverse(tree, segs, unbounded,
                                              walk_index=index), 3)
    ub = kknn.traverse(tree, segs, unbounded, unroll=1, walk_index=index)
    ub_ms, ub_by = bound_of(ub, KNN_TIMED_QUERIES)
    x = segs.pts

    def cdist_topk():
        # in four chunks of queries: the whole distance matrix would take
        # 34 GB
        for c in q.split(KNN_TIMED_QUERIES // 4):
            torch.cdist(c, x).topk(k, largest=False)

    # CUDA events around the calls, as the port's own launches are timed:
    # this late in a full run the profiler lost 27 of 344 kernel records of
    # two calls in every session of two runs
    lib_ms = cuda_ms(cdist_topk, 2)
    say("knn-time", shape=f"{dset} {KNN_TIMED_QUERIES} external k={k}",
        ms=f"{ub_ms_run:.3f}", bound_ms=f"{ub_ms:.5f}", bound_by=ub_by,
        cdist_topk_ms=f"{lib_ms:.3f}", **counters(ub, ub_ms_run))
    return dict(max_abs_err=e, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_obs(runs) -> None:
    """The hacc clustering run under ``obs.instrumented(sync=True)``: the
    snapshot and trace validate, ``traversal_evals_total`` summed over
    phases equals the summed evals of the run's own walks and the launch
    counter the walk kernel's launches; then the warm time with and
    without collectors, eight of each in turns (the observer cost)."""
    dset, n, eps, mp, pts, plan, res0, _ = runs[0]
    evals = []

    def counted(*args, **kw):
        tr = walk_fn(*args, **kw)
        evals.append(int(tr.evals.sum()))
        return tr

    fdbscan._walk, walk_fn = counted, fdbscan._walk
    try:
        before = kt.walk.launches
        with obs.instrumented(sync=True) as (reg, tracer):
            res = repro_torch.dbscan(pts, eps, mp, query_plan=plan)
        launched = kt.walk.launches - before
    finally:
        fdbscan._walk = walk_fn
    check(torch.equal(res.labels, res0.labels)
          and torch.equal(res.core_mask, res0.core_mask),
          "the instrumented run changed the result")
    doc = reg.snapshot()
    obs.metrics.validate_snapshot(doc)
    tdoc = tracer.to_dict()
    obs.trace.validate_chrome_trace(tdoc)
    fam = {m["name"]: m for m in doc["metrics"]}
    total = sum(s["value"] for s in fam["traversal_evals_total"]["series"])
    check(total == sum(evals), f"traversal_evals_total {total} != the "
                               f"walks' evals {sum(evals)}")
    check({s["labels"]["engine"]
           for s in fam["traversal_evals_total"]["series"]} == {"cuda"},
          "the walks are not labelled as the CUDA engine")
    kernel = sum(s["value"]
                 for s in fam["pallas_kernel_launches_total"]["series"])
    check(kernel == launched, f"launch counter {kernel} != {launched} "
                              "walk launches")
    spans = [e["name"] for e in tdoc["traceEvents"]]
    check(spans[0] == "traverse" and spans[-1] == "dbscan"
          and spans.count("sweep") == res.n_sweeps - 1,
          f"spans out of order: {spans}")
    times = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * 4:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "on":
            with obs.instrumented(sync=True):
                repro_torch.dbscan(pts, eps, mp, query_plan=plan)
        else:
            repro_torch.dbscan(pts, eps, mp, query_plan=plan)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3)
    say("obs", dataset=dset, n=n, spans=len(spans), metrics=len(fam),
        evals_total=int(total), walk_launches=launched,
        warm_ms_off=",".join(f"{t:.1f}" for t in times["off"]),
        warm_ms_on=",".join(f"{t:.1f}" for t in times["on"]),
        observer_ms=f"{np.median(times['on']) - np.median(times['off']):.1f}",
        ok=True)


# --------------------------------------------------------------------- #
# the streaming index                                                    #
# --------------------------------------------------------------------- #

def _x_window(pts: np.ndarray):
    """Points sorted by their first axis: a cheap superset of each
    query's eps-ball for the sampled oracles below."""
    order = np.argsort(pts[:, 0], kind="stable")
    return order, pts[order, 0]


def _ball(pts, win, q, r32) -> np.ndarray:
    """Ids of ``pts`` within ``r32`` of ``q`` in the walk's rounding."""
    order, xs = win
    lo = np.searchsorted(xs, q[0] - 2 * r32, "left")
    hi = np.searchsorted(xs, q[0] + 2 * r32, "right")
    cand = order[lo:hi]
    d2 = np_d2(q[None, :], pts[cand])
    return cand[d2 <= r32 * r32]


def stream_probes(rng, nxt: np.ndarray, lo, hi) -> np.ndarray:
    half = STREAM_BATCH // 2
    uni = rng.uniform(lo, hi, (STREAM_BATCH - half, 2)).astype(np.float32)
    return np.concatenate([nxt[:half], uni])


def run_stream(workdir: str) -> dict:
    """Drive the streaming index at full scale: ``stream_handle`` over the
    porto bootstrap set with a window, a WAL and a checkpoint; inserts
    (each expiring the oldest batch), deletes, one merge, one checkpoint,
    probe queries after every insert, the final snapshot and a restore
    from the checkpoint and the WAL. Every op is timed on the host clock
    around a synchronised call."""
    from repro_torch.stream import StreamingDBSCAN
    dset, n, eps, mp = STREAM
    allp = pointclouds.load(dset, n + STREAM_BATCHES * STREAM_BATCH)
    boot = allp[:n]
    batches = [allp[n + i * STREAM_BATCH:n + (i + 1) * STREAM_BATCH]
               for i in range(STREAM_BATCHES)]
    lo, hi = allp.min(0), allp.max(0)
    rng = np.random.default_rng(11)
    wal = os.path.join(workdir, "wal.bin")
    ckpt = os.path.join(workdir, "ckpt.npz")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {"inserts": [], "deletes": [], "queries": [], "probes": []}

    def clock(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    h, out["bootstrap_s"] = clock(
        lambda: repro_torch.stream_handle(boot, eps, mp, window=n, wal=wal,
                                          checkpoint_path=ckpt))
    for i, batch in enumerate(batches):
        if i + 1 < len(batches):
            _, s = clock(h.insert, batch)
        else:
            # the last insert under the port's span tracer: where an
            # insert's time goes (host clock, spans nest)
            with obs.instrumented() as (reg, tracer):
                _, s = clock(h.insert, batch)
            out["split"] = tracer.events
            out["split_launches"] = {
                kind: int(reg.get("pallas_kernel_launches_total",
                                  kind=kind).value)
                for kind in kt.KIND_NAMES
                if reg.get("pallas_kernel_launches_total", kind=kind)}
        out["inserts"].append(s)
        if (i + 1) % 4 == 0:
            alive = h.active_gids
            gone = np.sort(rng.choice(alive, int(len(alive)
                                                 * STREAM_DELETE_FRAC),
                                      replace=False))
            k, s = clock(h.delete, gone)
            check(k == len(gone), f"stream delete removed {k} of "
                                  f"{len(gone)} ids")
            out["deletes"].append(s)
        if i + 1 == STREAM_MERGE_AT:
            _, out["merge_s"] = clock(h.merge)
        if i + 1 == STREAM_CKPT_AT:
            _, out["checkpoint_s"] = clock(h.checkpoint)
        nxt = batches[i + 1] if i + 1 < len(batches) else batch
        probes = stream_probes(rng, nxt, lo, hi)
        q, s = clock(h.query, probes)
        out["queries"].append(s)
        out["probes"].append((probes, q, h.points))
    out["snapshot"], out["snapshot_s"] = clock(h.snapshot)
    restored, out["restore_s"] = clock(
        lambda: StreamingDBSCAN.restore(ckpt, wal=wal))
    out["restored"] = restored.snapshot()
    restored._wal.close()
    h._wal.close()
    out["handle"] = h
    out["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    return out


def check_stream(out: dict, seen: dict) -> None:
    """The stream path's launches; probe counts against the numpy oracle;
    the final snapshot against batch fdbscan on the survivors, its borders
    against the rule, and the restored handle's snapshot against the live
    one's; dbscan(algorithm="stream") against fdbscan on the bootstrap
    set."""
    dset, n, eps, mp = STREAM
    check(seen["walk"] > 0, "the walk kernel never ran on the stream path")
    check(seen["plain_walk_runs"] == 0, f"the plain walk ran "
          f"{seen['plain_walk_runs']} times on the stream path")
    h = out["handle"]
    r32 = np.float32(eps)
    checked = 0
    for probes, q, active in out["probes"]:
        check(q.labels.shape == (STREAM_BATCH,) and q.labels.dtype == np.int32
              and q.counts.dtype == np.int32, "stream query malformed")
        win = _x_window(active)
        for row in _sampled(STREAM_BATCH, 9 + checked):
            want = min(len(_ball(active, win, probes[row], r32)), mp)
            check(int(q.counts[row]) == want
                  and bool(q.would_be_core[row]) == (want + 1 >= mp),
                  f"stream query probe {row}: count {q.counts[row]} != "
                  f"oracle {want}")
        checked += 1
    snap, restored = out["snapshot"], out["restored"]
    check(torch.equal(snap.labels, restored.labels)
          and torch.equal(snap.core_mask, restored.core_mask)
          and snap.n_clusters == restored.n_clusters,
          "restored handle's snapshot differs from the live handle's")
    surv = h.points
    check_result(snap, len(surv), "stream snapshot")
    batch = repro_torch.dbscan(surv, eps, mp, algorithm="fdbscan")
    torch.cuda.synchronize()
    labels, core = snap.labels.cpu().numpy(), snap.core_mask.cpu().numpy()
    validate.check_component_identical(labels, core,
                                       batch.labels.cpu().numpy(),
                                       batch.core_mask.cpu().numpy())
    # borders: the min label among the core points within eps
    win = _x_window(surv)
    borders = np.flatnonzero(~core & (labels >= 0))
    pick = borders[_sampled(len(borders), 10)] if len(borders) > \
        ORACLE_QUERIES else borders
    for b in pick:
        nb = _ball(surv, win, surv[b], r32)
        nb = nb[core[nb]]
        check(len(nb) > 0 and labels[b] == labels[nb].min(),
              f"stream border {b}: label {labels[b]}, core neighbours' "
              f"labels {np.unique(labels[nb])}")
    boot = pointclouds.load(dset, n)
    one = repro_torch.dbscan(boot, eps, mp, algorithm="stream")
    ref = repro_torch.dbscan(boot, eps, mp, algorithm="fdbscan")
    check(one.backend == "stream" and one.labels.device.type == "cuda",
          f"dbscan(algorithm='stream') ran as {one.backend}")
    validate.check_component_identical(one.labels.cpu().numpy(),
                                       one.core_mask.cpu().numpy(),
                                       ref.labels.cpu().numpy(),
                                       ref.core_mask.cpu().numpy())
    ins = np.array(out["inserts"]) * 1e3
    say("stream", dataset=dset, n=n, batch=STREAM_BATCH,
        batches=STREAM_BATCHES, eps=eps, min_pts=mp,
        bootstrap_s=f"{out['bootstrap_s']:.3f}",
        insert_ms_p50=f"{np.median(ins):.1f}", insert_ms_max=f"{ins.max():.1f}",
        delete_ms=",".join(f"{s * 1e3:.1f}" for s in out["deletes"]),
        query_ms_p50=f"{np.median(out['queries']) * 1e3:.1f}",
        query_ms_max=f"{max(out['queries']) * 1e3:.1f}",
        merge_s=f"{out['merge_s']:.3f}",
        checkpoint_s=f"{out['checkpoint_s']:.3f}",
        restore_s=f"{out['restore_s']:.3f}",
        snapshot_ms=f"{out['snapshot_s'] * 1e3:.1f}",
        repair_sweeps=h.n_repair_sweeps, merges=h.n_merges,
        compactions=h.n_compactions, tiers=h.n_tiers,
        walk_launches=seen["walk"],
        peak_mb_over_start=f"{out['peak_mb']:.0f}")
    say("check", path="stream", vs="fdbscan on the survivors + numpy "
        "oracle + restore", ok=True, survivors=len(surv),
        n_clusters=snap.n_clusters, oracle_probes=checked * ORACLE_QUERIES,
        borders_checked=len(pick))
    ms, calls = {}, {}
    for e in out["split"]:
        ms[e["name"]] = ms.get(e["name"], 0.0) + e["dur"] / 1e3
        calls[e["name"]] = calls.get(e["name"], 0) + 1
    say("stream-split", op="last insert", **{
        f"{name.replace('stream.', '')}_ms": f"{t:.1f}x{calls[name]}"
        for name, t in sorted(ms.items())},
        **{f"{kind}_launches": k
           for kind, k in out["split_launches"].items()})


def _stream_state(h) -> dict:
    host = (lambda t: t.cpu().numpy())
    return {"counts": host(h._counts), "core": host(h._core),
            "labels": host(h._labels), "tombstone": host(h._tombstone),
            "levels": [host(lv.gids) for lv in h._levels()],
            "counters": (h.n_points, h.n_repair_sweeps, h.n_compactions,
                         h.n_merges, h.n_tiers)}


def _same_stream(a, b, what: str) -> None:
    sa, sb = _stream_state(a), _stream_state(b)
    for key in ("counts", "core", "labels", "tombstone"):
        check(sa[key].dtype == sb[key].dtype
              and np.array_equal(sa[key], sb[key]),
              f"stream parity {what}: {key} differs")
    check(sa["counters"] == sb["counters"]
          and len(sa["levels"]) == len(sb["levels"])
          and all(np.array_equal(x, y)
                  for x, y in zip(sa["levels"], sb["levels"])),
          f"stream parity {what}: counters or levels differ")


def phase_stream_parity() -> None:
    """The streaming index on the card (every level walk the kernel)
    against the same index on the host (every walk the plain engine),
    byte for byte after every op: bootstrap with a window, inserts that
    seal tiers, a delete, a merge, queries and both snapshots."""
    from repro_torch.stream import StreamingDBSCAN
    b = STREAM_PARITY_BATCH
    for dset, n, eps, mp in STREAM_PARITY:
        pts = pointclouds.load(dset, n + 2 * b, seed=4)
        hs = [StreamingDBSCAN(pts[:n], eps, mp, window=n, buffer_max=100,
                              device=dev) for dev in (DEV, "cpu")]
        _same_stream(*hs, f"{dset} bootstrap")
        rng = np.random.default_rng(5)
        for i in range(2):
            for h in hs:
                h.insert(pts[n + i * b:n + (i + 1) * b])
            _same_stream(*hs, f"{dset} insert {i}")
            if i == 1:
                gone = np.sort(rng.choice(hs[0].active_gids, b // 5,
                                          replace=False))
                check(hs[0].delete(gone) == hs[1].delete(gone),
                      "stream parity: deletes differ")
                for h in hs:
                    h.merge()
                _same_stream(*hs, f"{dset} delete + merge")
            probes = np.concatenate([
                pts[n + i * b:n + i * b + 100],
                rng.uniform(pts.min(0), pts.max(0),
                            (100, pts.shape[1])).astype(np.float32)])
            qa, qb = (h.query(probes) for h in hs)
            check(all(np.array_equal(x, y) for x, y in zip(qa, qb)),
                  f"stream parity {dset}: query {i} differs")
        for star in (False, True):
            sa, sb = (h.snapshot(star=star) for h in hs)
            check(torch.equal(sa.labels.cpu(), sb.labels)
                  and torch.equal(sa.core_mask.cpu(), sb.core_mask)
                  and sa.n_clusters == sb.n_clusters,
                  f"stream parity {dset}: snapshot star={star} differs")
        say("stream-parity", dataset=dset, n=n, d=pts.shape[1],
            repair_sweeps=hs[0].n_repair_sweeps,
            compactions=hs[0].n_compactions, ok=True)


# --------------------------------------------------------------------- #
# the serving plane                                                      #
# --------------------------------------------------------------------- #

def serve_probes(rng, pts: np.ndarray, k: int, lo, hi) -> np.ndarray:
    """``k`` probes: half residents jittered by a fifth of the smallest
    eps, half uniform in the bounding box."""
    half = k // 2
    near = pts[rng.integers(0, len(pts), half)] + rng.normal(
        0.0, 0.2 * SERVE_TENANTS[0][1], (half, 2)).astype(np.float32)
    uni = rng.uniform(lo, hi, (k - half, 2)).astype(np.float32)
    return np.concatenate([near, uni]).astype(np.float32)


def run_serve(workdir: str) -> dict:
    """Drive the serving plane at the stream run's size through its entry
    points: ``Server`` over the porto bootstrap set (two tenants, durability
    on), inserts submitted in turn while query clients run, then an idle
    spell, ``shutdown()`` and ``Server.restore``. Every snapshot's frozen
    state is kept (``IndexSnapshot.build`` recorded) for the checks.
    Collectors are installed without sync, so no span waits on the card."""
    from repro_torch import serve
    from repro_torch.serve import snapshot as serve_snapshot
    dset, n, _, _ = STREAM
    allp = pointclouds.load(dset, n + (SERVE_INSERTS + 1) * SERVE_BATCH)
    boot = allp[:n]
    lo, hi = allp.min(0), allp.max(0)
    frozen = {}                         # (eps, min_pts, version) -> state
    build = serve_snapshot.IndexSnapshot.build.__func__

    def recorded(cls, state, eps, min_pts, *, version=0):
        frozen[(eps, min_pts, version)] = state
        return build(cls, state, eps, min_pts, version=version)

    out = {"acks": [], "ack_s": [], "replies": [[] for _ in
                                                range(SERVE_CLIENTS)]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    syncs0 = serve_snapshot.IndexSnapshot.host_syncs
    serve_snapshot.IndexSnapshot.build = classmethod(recorded)
    try:
        with obs.instrumented(sync=False) as (reg, tracer):
            t0 = time.perf_counter()
            srv = serve.Server(boot, SERVE_TENANTS, durability_dir=workdir,
                               checkpoint_every=4, keep_versions=16)
            torch.cuda.synchronize()
            out["bootstrap_s"] = time.perf_counter() - t0
            stop, phase, errors = threading.Event(), ["writes"], []

            def client(i):
                rng = np.random.default_rng(100 + i)
                try:
                    while not stop.is_set():
                        k = int(rng.integers(SERVE_PROBES[0],
                                             SERVE_PROBES[1] + 1))
                        name = SERVE_TENANTS[int(rng.integers(0, 2))][0]
                        probes = serve_probes(rng, allp, k, lo, hi)
                        ph = phase[0]
                        t = time.perf_counter()
                        rep = srv.query(probes, tenant=name, timeout=300)
                        out["replies"][i].append(
                            (name, probes, rep, time.perf_counter() - t, ph))
                except Exception as e:          # reported by the check
                    errors.append(repr(e))

            clients = [threading.Thread(target=client, args=(i,))
                       for i in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for c in clients:
                c.start()
            for i in range(SERVE_INSERTS):
                batch = allp[n + i * SERVE_BATCH:n + (i + 1) * SERVE_BATCH]
                t = time.perf_counter()
                out["acks"].append(srv.insert(batch, timeout=600))
                out["ack_s"].append(time.perf_counter() - t)
            phase[0] = "idle"
            time.sleep(SERVE_IDLE_S)
            stop.set()
            for c in clients:
                c.join(600)
            out["clients_s"] = time.perf_counter() - t0
            check(not any(c.is_alive() for c in clients) and not errors,
                  f"serve query clients failed: {errors}")
            n_events = len(tracer.events)
            batch = allp[n + SERVE_INSERTS * SERVE_BATCH:]
            t = time.perf_counter()
            srv.insert(batch, timeout=600)
            out["ack_alone_s"] = time.perf_counter() - t
            out["last"] = {v.name: v.store.current() for v in srv._views}
            out["stores"] = {v.name: v.store for v in srv._views}
            out["active"] = {v.name: v.handle.n_active for v in srv._views}
            srv.shutdown()
            out["syncs"] = serve_snapshot.IndexSnapshot.host_syncs - syncs0
            out["flushes"] = sum(
                reg.get("serve_flushes_total", reason=r).value
                for r in ("full", "deadline", "drain")
                if reg.get("serve_flushes_total", reason=r))
            out["exact"] = reg.get("serve_snapshot_exact_probes_total").value
            out["probes"] = reg.get("serve_batch_probes").sum
            out["index_builds"] = reg.get("dispatch_index_builds_total",
                                          index="fdbscan").value
            out["publish_ms"] = [e["dur"] / 1e3 for e in tracer.events
                                 if e["name"] == "serve.freeze"]
            out["spans"] = {"clients": {}, "alone": {}}
            for i, e in enumerate(tracer.events):
                spans = out["spans"]["clients" if i < n_events else "alone"]
                ms, k = spans.get(e["name"], (0.0, 0))
                spans[e["name"]] = (ms + e["dur"] / 1e3, k + 1)
    finally:
        serve_snapshot.IndexSnapshot.build = classmethod(build)
    out["frozen"] = frozen
    torch.cuda.synchronize()
    out["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    # the frozen states kept above for the checks are the check's, not
    # the server's: the peak holds them, so give their size beside it
    out["kept_mb"] = sum(st.pts.nbytes + st.vals.nbytes
                         for st in frozen.values()) / 2**20
    t0 = time.perf_counter()
    out["restored"] = serve.Server.restore(
        SERVE_TENANTS, durability_dir=workdir, checkpoint_every=4,
        device="cuda")
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["allp"], out["lo"], out["hi"] = allp, lo, hi
    return out


def _eager_d2(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    """float32 squared distances rounded as numpy's eager ``(diff *
    diff).sum(-1)``: every product and sum rounded on its own."""
    diff = (q - p).astype(np.float32)
    out = diff[..., 0] * diff[..., 0]
    for c in range(1, diff.shape[-1]):
        out = out + diff[..., c] * diff[..., c]
    return out


def check_serve(out: dict, seen: dict) -> None:
    """Every reply's version was published by its tenant's store and never
    goes down for a client; sampled replies equal the same version's
    snapshot rebuilt on the host; sampled probes of each final snapshot
    agree with an eager float32 numpy oracle; one index build for both
    tenants; each tenant's final frozen state is component-identical to
    fdbscan on its active points; the restored server answers as the last
    snapshot before shutdown."""
    from repro_torch import serve
    check(seen["walk"] > 0, "the walk kernel never ran on the serve path")
    check(seen["plain_walk_runs"] == 0, f"the plain walk ran "
          f"{seen['plain_walk_runs']} times on the serve path")
    check(out["index_builds"] == 1, f"{out['index_builds']} index builds "
          "for two tenants over one point set, not 1")
    spec = {name: (eps, mp) for name, eps, mp in SERVE_TENANTS}
    lat = {"writes": [], "idle": []}
    by_tenant = {name: [] for name in spec}
    for replies in out["replies"]:
        last = {name: -1 for name in spec}
        for name, probes, rep, s, ph in replies:
            check(rep.tenant == name and rep.version >= last[name],
                  f"client saw {name} v{rep.version} after v{last[name]}")
            check(out["stores"][name].get(rep.version) is not None,
                  f"{name} v{rep.version} was never published")
            check(rep.labels.shape == (len(probes),)
                  and rep.labels.dtype == np.int32
                  and rep.counts.dtype == np.int32, "serve reply malformed")
            last[name] = rep.version
            lat[ph].append(s)
            by_tenant[name].append((probes, rep))
    host = {}
    for name, (eps, mp) in spec.items():
        replies = by_tenant[name]
        check(len(replies) >= SERVE_SAMPLED, f"{name}: {len(replies)} "
              "replies, fewer than the sample")
        pick = np.random.default_rng(12).choice(len(replies), SERVE_SAMPLED,
                                                replace=False)
        for j in sorted(pick, key=lambda j: replies[j][1].version):
            probes, rep = replies[j]
            if (name, rep.version) not in host:
                st = out["frozen"][(eps, mp, rep.version)]
                host[(name, rep.version)] = serve.IndexSnapshot.build(
                    st._replace(pts=st.pts.cpu(), vals=st.vals.cpu()), eps,
                    mp, version=rep.version)
            want = host[(name, rep.version)].query(probes)
            check(all(np.array_equal(getattr(want, f), getattr(rep, f))
                      for f in ("labels", "counts", "would_be_core")),
                  f"{name} v{rep.version}: the card's reply differs from "
                  "the snapshot rebuilt on the host")
    rng = np.random.default_rng(13)
    probes = serve_probes(rng, out["allp"], ORACLE_QUERIES, out["lo"],
                          out["hi"])
    for name, (eps, mp) in spec.items():
        last = out["last"][name]
        st = out["frozen"][(eps, mp, last.version)]
        pts, vals = st.pts.cpu().numpy(), st.vals.cpu().numpy()
        check(len(pts) == out["active"][name] == last.n_points,
              f"{name}: final frozen state holds {len(pts)} points")
        q = last.query(probes)
        win, e2 = _x_window(pts), np.float32(np.float32(eps) ** 2)
        order, xs = win
        for row, p in enumerate(probes):
            a = np.searchsorted(xs, p[0] - 2 * eps, "left")
            b = np.searchsorted(xs, p[0] + 2 * eps, "right")
            cand = order[a:b]
            nb = cand[_eager_d2(p[None, :], pts[cand]) <= e2]
            lab = int(vals[nb].min()) if len(nb) else traversal.INT_MAX
            want = (-1 if lab == traversal.INT_MAX else lab, min(len(nb), mp))
            check((int(q.labels[row]), int(q.counts[row])) == want
                  and bool(q.would_be_core[row]) == (want[1] + 1 >= mp),
                  f"{name} probe {row}: ({q.labels[row]}, {q.counts[row]})"
                  f" != oracle {want}")
        core = vals != traversal.INT_MAX
        ref = repro_torch.dbscan(pts, eps, mp, algorithm="fdbscan")
        rc = ref.core_mask.cpu().numpy()
        validate.check_component_identical(
            np.where(core, vals, -1), core,
            np.where(rc, ref.labels.cpu().numpy(), -1), rc)
        back = out["restored"].query(probes, tenant=name, timeout=300)
        check(all(np.array_equal(getattr(q, f), getattr(back, f))
                  for f in ("labels", "counts", "would_be_core")),
              f"{name}: the restored server answers unlike the last "
              "snapshot before shutdown")
    out["restored"].shutdown(final_checkpoint=False)  # its files are gone
    # one flush of the oracle probes alone, no batching: its time (CUDA
    # events around 20 calls, each of which ends with its results on the
    # host) and the device operations the profiler records in one
    from torch.profiler import ProfilerActivity, profile
    last = out["last"][SERVE_TENANTS[0][0]]
    flush_ms = cuda_ms(lambda: last.query(probes), 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        last.query(probes)
        torch.cuda.synchronize()
    ops = sum(e.device_type == torch.autograd.DeviceType.CUDA
              for e in prof.events())

    def ms(xs, q):
        return f"{np.quantile(np.array(xs) * 1e3, q):.1f}"

    n_replies = sum(len(r) for r in out["replies"])
    acks = out["acks"]
    say("serve", dataset=STREAM[0], n=STREAM[1],
        tenants=",".join(f"{n_}:{e}:{m}" for n_, e, m in SERVE_TENANTS),
        inserts=f"{len(acks)}x{SERVE_BATCH}",
        bootstrap_s=f"{out['bootstrap_s']:.3f}",
        publish_ms_p50=f"{np.median(out['publish_ms']):.1f}",
        publish_ms_max=f"{max(out['publish_ms']):.1f}",
        publishes=len(out["publish_ms"]),
        insert_ack_ms_p50=ms(out["ack_s"], 0.5),
        insert_ack_ms_max=f"{max(out['ack_s']) * 1e3:.1f}",
        insert_ack_ms_alone=f"{out['ack_alone_s'] * 1e3:.1f}",
        query_ms_p50_writes=ms(lat["writes"], 0.5),
        query_ms_p99_writes=ms(lat["writes"], 0.99),
        query_ms_p50_idle=ms(lat["idle"], 0.5),
        query_ms_p99_idle=ms(lat["idle"], 0.99),
        replies=n_replies, replies_writes=len(lat["writes"]),
        probes_per_s=f"{out['probes'] / out['clients_s']:.0f}",
        exact_probe_share=f"{out['exact'] / out['probes']:.4f}",
        flushes=int(out["flushes"]),
        host_syncs_per_flush=f"{out['syncs'] / out['flushes']:.2f}",
        flush_ms=f"{flush_ms:.2f}", device_ops_per_flush=ops,
        walk_launches=seen["walk"], plain_walks=seen["plain_walk_runs"],
        peak_mb_over_start=f"{out['peak_mb']:.0f}",
        frozen_kept_mb=f"{out['kept_mb']:.0f}",
        restore_s=f"{out['restore_s']:.3f}")
    # where the writer's time goes (host clock, spans nest, no sync):
    # the apply of a batch to both tenants, each tenant's insert, its
    # repair and compaction, the publishes; with the query clients running
    # and for the last batch, alone
    for when, spans in out["spans"].items():
        say("serve-split", writer=when, **{
            f"{name}_ms": f"{ms:.1f}x{k}" for name, (ms, k) in sorted(
                spans.items())
            if name in ("serve.apply", "serve.publish", "serve.freeze",
                        "stream.insert", "stream.repair", "stream.compact",
                        "stream.merge", "serve.bootstrap")})
    say("check", path="serve", vs="published versions + host rebuild + "
        "numpy oracle + fdbscan + restore", ok=True,
        sampled_replies=SERVE_SAMPLED * len(spec), host_rebuilds=len(host),
        oracle_probes=ORACLE_QUERIES * len(spec),
        versions=",".join(f"{k}:{v.version}"
                          for k, v in out["last"].items()))


def phase_serve_cli(workdir: str) -> None:
    """The serving CLI on the card in a process of its own: server mode
    with two tenants, durability and --validate, then --restore."""
    dset, _, _, _ = STREAM
    tenants = ",".join(f"{n}:{e}:{m}" for n, e, m in SERVE_TENANTS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for extra in ([], ["--restore"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve",
               "--dataset", dset, "--n", str(SERVE_CLI_N),
               "--tenants", tenants, "--device", "cuda", "--validate",
               "--durability-dir", workdir,
               "--steps", str(SERVE_CLI_STEPS)] + extra
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        lines = run.stdout.strip().splitlines()
        check(run.returncode == 0, f"serve CLI {extra} exited "
              f"{run.returncode}:\n{run.stdout[-2000:]}{run.stderr[-4000:]}")
        check(any("validation of 2 tenants" in ln for ln in lines),
              f"serve CLI {extra} printed no validation line")
        for ln in lines:
            print(f"[serve-cli] {ln}", flush=True)
        say("serve-cli", mode="restore" if extra else "bootstrap",
            n=SERVE_CLI_N, rc=run.returncode,
            seconds=f"{time.perf_counter() - t0:.1f}", ok=True)


# --------------------------------------------------------------------- #
# the tuner: lane tiles and lane orders on the walk kernel              #
# --------------------------------------------------------------------- #

def _golden():
    return np.load(os.path.join(ROOT, "tests", "golden", "golden.npz"))


def _tune_cases(segs, tree, eps, mp):
    """The clustering phases' walk shapes (:func:`_walk_cases`: the fused
    first pass over every point, a split sweep with a tail of inert lanes,
    the count pass over loose points) and two external batches (uniform
    points in the index's box, a count and a min-label walk)."""
    cases = _walk_cases(segs, tree, eps, mp)
    n, d = segs.pts.shape
    g = torch.Generator(device="cpu").manual_seed(4)
    lo, hi = segs.pts.amin(0), segs.pts.amax(0)
    q = lo + (hi - lo) * torch.rand(4099, d, generator=g).to(DEV)
    ext = traversal.intersects(traversal.sphere(eps), pts=q)
    vals = torch.arange(n, dtype=torch.int32, device=DEV)
    gather = (torch.rand(n, generator=g) < 0.5).to(DEV)
    cases.append(("count external", ext, traversal.CountVisitor(cap=mp), {}))
    cases.append(("minlabel external", ext,
                  traversal.MinLabelVisitor(vals, gather), {}))
    return cases


def _same_trace(name, a, b) -> float:
    e = max_abs_err([(a.acc, b.acc), (a.hits, b.hits), (a.evals, b.evals),
                     (a.iters, b.iters)])
    check(e == 0.0, f"{name}: differs from the pinned launch "
                    f"(max abs err {e})")
    return e


def phase_tune_check() -> float:
    """The walk kernel at every lane tile of ``tune.TUNE_LANE_TILES`` under
    every lane order (none, morton, depth by the first pass's trips),
    exact against the pinned launch (block 128, launch order): ``acc``,
    ``hits``, ``evals`` and ``iters`` (same unroll), for the three kinds on
    the clustering phases' lanes (inert lanes included) and on external
    lanes, on the 262,144-point densebox indexes of :func:`phase_walk_check`.
    Then the reference's golden uncapped counts at n = 800 through the
    kernel (``traversal.count_neighbors`` and every lane tile in Morton
    order), and the traversal helpers on the card against the same helpers
    on a host copy of the index (the plain engine)."""
    from repro_torch.core import tune
    err = 0.0
    for dset, n, eps, mp in WALK_CHECK:
        segs, tree, index = _index(dset, n, eps, mp)
        cases = _tune_cases(segs, tree, eps, mp)
        rank = None
        for name, pred, cb, kw in cases:
            pinned = kt.traverse(tree, segs, pred, cb, walk_index=index,
                                 **kw)
            if rank is None:        # the first pass: every point, in order
                rank = pinned.iters
            times = {}
            for lane_tile in tune.TUNE_LANE_TILES:
                for policy in ("none", "morton", "depth"):
                    before = kt.walk.launches
                    k = kt.traverse(tree, segs, pred, cb, walk_index=index,
                                    lane_tile=lane_tile, reorder=policy,
                                    depth_rank=rank, **kw)
                    torch.cuda.synchronize()
                    check(kt.walk.last_block == lane_tile
                          and kt.walk.launches == before + 1,
                          f"tune-check {name}: block {kt.walk.last_block}")
                    err = max(err, _same_trace(
                        f"tune-check {dset} {name} {lane_tile}/{policy}",
                        pinned, k))
                    times[f"{lane_tile}/{policy}"] = cuda_ms(
                        lambda: kt.traverse(tree, segs, pred, cb,
                                            walk_index=index,
                                            lane_tile=lane_tile,
                                            reorder=policy, depth_rank=rank,
                                            **kw), 3)
            say("tune-check", dataset=dset, n=n, walk=repr(name),
                lanes=int(pinned.iters.shape[0]),
                inert=int((pinned.iters == 0).sum()), max_abs_err=err,
                **{f"ms_{key}": f"{v:.3f}" for key, v in times.items()})
        del segs, tree, index, cases, rank
    golden = _golden()
    counted = 0
    for dset, n, eps, mp in GOLDEN_SCENARIOS:
        p = repro_torch.plan(pointclouds.load(dset, n), eps, mp,
                             algorithm="fdbscan", device=DEV)
        order = p.segs.order.long().cpu().numpy()
        before = (kt.walk.launches, traversal.traverse.runs)
        got = traversal.count_neighbors(p.tree, p.segs, eps,
                                        traversal.INT_MAX,
                                        walk_index=p.walk_index)
        counts = np.zeros(n, np.int64)
        counts[order] = got.cpu().numpy()
        check(np.array_equal(counts, golden[f"{dset}/counts"]),
              f"golden counts {dset}: the walk kernel differs")
        for lane_tile in tune.TUNE_LANE_TILES:
            k = kt.traverse(p.tree, p.segs,
                            traversal.intersects(traversal.sphere(eps)),
                            traversal.CountVisitor(cap=traversal.INT_MAX),
                            lane_tile=lane_tile, reorder="morton",
                            walk_index=p.walk_index)
            counts[order] = k.acc.cpu().numpy()
            check(np.array_equal(counts, golden[f"{dset}/counts"]),
                  f"golden counts {dset}: lane tile {lane_tile} differs")
        check(kt.walk.launches == before[0] + 1 + len(tune.TUNE_LANE_TILES)
              and traversal.traverse.runs == before[1],
              f"golden counts {dset}: not every walk was the kernel")
        counted += 1
        if dset == "hacc_like":
            err = max(err, _helpers_against_host(p, eps, mp))
    say("tune-check", golden_counts=counted, lane_tiles=len(
        tune.TUNE_LANE_TILES), helpers="count_neighbors_with_work,"
        "minlabel_sweep,fused_count_minlabel,border_gather", max_abs_err=err)
    return err


def _helpers_against_host(p, eps: float, mp: int) -> float:
    """The traversal helpers on the card (walk kernel, packed index from
    the plan and packed by the helper itself) against the same helpers on
    a host copy of the index (plain engine), exact."""
    segs_h = grid.Segments(*(x.cpu() for x in p.segs))
    tree_h = lbvh.Tree(*(x.cpu() for x in p.tree))
    n = p.segs.n_points
    g = torch.Generator(device="cpu").manual_seed(6)
    labels = torch.randperm(n, generator=g).to(torch.int32)
    gather = torch.rand(n, generator=g) < 0.6
    active = torch.rand(n, generator=g) < 0.7
    err = 0.0
    before = (kt.walk.launches, traversal.traverse.runs)
    for walk_index in (p.walk_index, None):
        on = dict(walk_index=walk_index)
        pairs = [
            (traversal.count_neighbors_with_work(
                p.tree, p.segs, eps, mp, active.to(DEV), **on),
             traversal.count_neighbors_with_work(tree_h, segs_h, eps, mp,
                                                 active)),
            (traversal.minlabel_sweep(p.tree, p.segs, eps, labels.to(DEV),
                                      gather.to(DEV), active.to(DEV), **on),
             traversal.minlabel_sweep(tree_h, segs_h, eps, labels, gather,
                                      active)),
            (traversal.border_gather(p.tree, p.segs, eps, labels.to(DEV),
                                     gather.to(DEV), active.to(DEV), **on),
             traversal.border_gather(tree_h, segs_h, eps, labels, gather,
                                     active)),
        ]
        fk = traversal.fused_count_minlabel(p.tree, p.segs, eps,
                                            labels.to(DEV), cap=mp - 1, **on)
        fh = traversal.fused_count_minlabel(
            tree_h, segs_h, eps, labels, cap=mp - 1,
            traverse_fn=lambda *a, **k: traversal.traverse(
                *a, unroll=kt.PALLAS_UNROLL, **k))
        pairs.append(((fk.acc, fk.hits, fk.evals, fk.iters),
                      (fh.acc, fh.hits, fh.evals, fh.iters)))
        for dev_out, host_out in pairs:
            e = max_abs_err([(a.cpu(), b) for a, b in zip(dev_out,
                                                           host_out)])
            check(e == 0.0, f"traversal helper on the card differs from the "
                            f"host's (max abs err {e})")
            err = max(err, e)
    host_runs = traversal.traverse.runs - before[1]
    check(kt.walk.launches - before[0] == 8 and host_runs == 8,
          f"helpers: {kt.walk.launches - before[0]} kernel launches, "
          f"{host_runs} plain runs (8 each expected: 4 on the card, 4 on "
          f"the host, twice)")
    return err


def phase_tune(runs) -> dict:
    """Both full-size scenarios through ``dbscan(algorithm="pallas-tree")``
    under ``REPRO_TUNE`` = off, heuristic and search, on one index each:
    labels, core mask and ``n_sweeps`` byte-equal to the pinned run, no
    plain walk, one measured search for two plans with one ``stats_key``
    (the set and a permuted copy), and a CUDA tuner state forced to the
    plain engine raises. Prints each mode's decision, the search time and
    the warm ``cluster_ms`` (CUDA events; medians of 5, the modes in
    turns). The counts of the runs are read by the caller."""
    from repro_torch.core import dispatch, tune
    out = {}
    prev = os.environ.get("REPRO_TUNE")
    try:
        for dset, n, eps, mp, pts, _, res0, _ in runs:
            if n < 2**20:
                continue
            plans = {}
            for mode in ("off", "heuristic"):
                os.environ["REPRO_TUNE"] = mode
                dispatch.clear_cache()
                plans[mode] = repro_torch.plan(pts, eps, mp,
                                               algorithm="pallas-tree",
                                               device=DEV)
            os.environ["REPRO_TUNE"] = "search"
            dispatch.clear_cache()
            with obs.instrumented() as (reg, _):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plans["search"] = repro_torch.plan(pts, eps, mp,
                                                   algorithm="pallas-tree",
                                                   device=DEV)
                torch.cuda.synchronize()
                search_s = time.perf_counter() - t0
                perm = np.random.default_rng(1).permutation(n)
                p2 = repro_torch.plan(pts[perm], eps, mp,
                                      algorithm="pallas-tree", device=DEV)
            searches = reg.get("tune_searches_total").value
            check(searches == 1.0 and p2.tune.config
                  == plans["search"].tune.config,
                  f"{dset}: {searches} searches for two plans with one "
                  f"stats_key")
            del p2
            dispatch.clear_cache()
            pinned = None
            samples = {m: [] for m in plans}
            for rep in range(6):            # a cold run, then 5 warm
                for mode, p in plans.items():
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    res = repro_torch.dbscan(pts, eps, mp, query_plan=p)
                    end.record()
                    torch.cuda.synchronize()
                    if rep:
                        samples[mode].append(start.elapsed_time(end))
                    if pinned is None:
                        pinned = res
                    check(torch.equal(res.labels, pinned.labels)
                          and torch.equal(res.core_mask, pinned.core_mask)
                          and res.n_sweeps == pinned.n_sweeps
                          and res.backend == "pallas-tree",
                          f"{dset} REPRO_TUNE={mode}: differs from the "
                          f"pinned run")
            check(same_core_partition(pinned, res0),
                  f"{dset}: the pinned run differs from the main path's")
            ms = {m: float(np.median(v)) for m, v in samples.items()}
            for mode, p in plans.items():
                d = p.tune.describe()
                say("tune", dataset=dset, mode=mode,
                    cluster_ms=f"{ms[mode]:.2f}",
                    samples="/".join(f"{v:.1f}" for v in samples[mode]),
                    config=json.dumps({k: d[k] for k in
                                       ("source", "calibrated",
                                        "first_pass", "sweep", "border")},
                                      separators=(",", ":")))
            say("tune-search", dataset=dset, seconds=f"{search_s:.3f}",
                searches=int(searches),
                timings_ms=json.dumps({ph: {c: round(t * 1e3, 3)
                                            for c, t in v.items()}
                                       for ph, v in plans["search"].tune
                                       .info["timings"].items()},
                                      separators=(",", ":")))
            out[dset] = ms
            # a CUDA tuner state forced to the plain engine raises (and
            # runs no plain walk)
            forced = tune.TuneState(tune.TunedConfig(
                first_pass=tune.PhaseConfig("reference")))
            p = plans["off"]
            runs_before = traversal.traverse.runs
            try:
                fdbscan.cluster_from_index(p.segs, p.tree, eps, mp,
                                           backend="pallas-tree",
                                           tune=forced,
                                           walk_index=p.walk_index)
                raised = False
            except ValueError:
                raised = True
            check(raised and traversal.traverse.runs == runs_before,
                  f"{dset}: a CUDA phase forced to the plain engine ran")
            del plans, pinned, res
    finally:
        if prev is None:
            os.environ.pop("REPRO_TUNE", None)
        else:
            os.environ["REPRO_TUNE"] = prev
        from repro_torch.core import dispatch
        dispatch.clear_cache()
    return out


def phase_cluster_cli(workdir: str) -> None:
    """The clustering CLI (``python -m repro_torch.launch.cluster``) on the
    card in a process of its own, on hacc_like at CLUSTER_CLI_N points with
    ``auto`` and ``pallas-tree``: ``--out`` labels equal to the same run in
    this process; then ``gdbscan`` (the CLI's baseline) at CLUSTER_GDBSCAN_N
    boundary-separated points against ``dbscan_bruteforce_np``."""
    from repro_torch.core import baselines
    dset, n, eps, mp = CLUSTER_CLI
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    pts = pointclouds.load(dset, n)
    for algorithm in ("auto", "pallas-tree"):
        out = os.path.join(workdir, f"{algorithm}.npy")
        cmd = [sys.executable, "-m", "repro_torch.launch.cluster",
               "--data", dset, "-n", str(n), "--eps", str(eps),
               "--minpts", str(mp), "--algorithm", algorithm,
               "--out", out]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        check(run.returncode == 0, f"cluster CLI {algorithm} exited "
              f"{run.returncode}:\n{run.stdout[-2000:]}{run.stderr[-4000:]}")
        for ln in run.stdout.strip().splitlines():
            print(f"[cluster-cli] {ln}", flush=True)
        want = repro_torch.dbscan(pts, eps, mp, algorithm=algorithm)
        got = np.load(out)
        check(np.array_equal(got, want.labels.cpu().numpy()),
              f"cluster CLI {algorithm}: labels differ from the in-process "
              f"run")
        say("cluster-cli", algorithm=algorithm, n=n, backend=want.backend,
            n_clusters=want.n_clusters, rc=run.returncode,
            seconds=f"{time.perf_counter() - t0:.1f}", ok=True)
    out = os.path.join(workdir, "ring.npy")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--data", dset,
         "-n", str(n), "--eps", str(eps), "--minpts", str(mp),
         "--algorithm", "ring", "--out", out], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"cluster CLI ring exited {run.returncode}:"
          f"\n{run.stdout[-2000:]}{run.stderr[-4000:]}")
    for ln in run.stdout.strip().splitlines():
        print(f"[cluster-cli] {ln}", flush=True)
    from repro_torch.distributed.ring_dbscan import ring_dbscan
    want = ring_dbscan(pts, eps, mp)
    check(np.array_equal(np.load(out), want.labels.cpu().numpy()),
          "cluster CLI ring: labels differ from ring_dbscan in this process")
    say("cluster-cli", algorithm="ring", n=n, backend=want.backend,
        n_clusters=want.n_clusters, n_sweeps=want.n_sweeps,
        rc=run.returncode, seconds=f"{time.perf_counter() - t0:.1f}",
        ok=True)
    gn, geps, gmp = CLUSTER_GDBSCAN
    x = separated(gn, 3, geps, seed=8)
    t0 = time.perf_counter()
    res = baselines.gdbscan(x, geps, gmp)
    torch.cuda.synchronize()
    g_s = time.perf_counter() - t0
    labels, core = baselines.dbscan_bruteforce_np(x, geps, gmp)
    check(res.labels.device.type == "cuda"
          and np.array_equal(res.core_mask.cpu().numpy(), core)
          and validate.same_partition(res.labels.cpu().numpy()[core],
                                      labels[core])
          and res.n_clusters == int(labels.max()) + 1,
          "gdbscan on the card differs from dbscan_bruteforce_np")
    validate.check_dbscan(x, geps, gmp, res.labels.cpu().numpy(),
                          res.core_mask.cpu().numpy())
    say("cluster-cli", algorithm="gdbscan", n=gn, d=3,
        n_clusters=res.n_clusters, core=int(core.sum()),
        seconds=f"{g_s:.2f}", vs="dbscan_bruteforce_np", ok=True)


# --------------------------------------------------------------------- #
# the distributed path: sharded tree, dense ring, group mesh             #
# --------------------------------------------------------------------- #

@contextlib.contextmanager
def recorded_walks(log: list):
    """Record every walk the distributed path makes through
    ``kernels.traverse.traverse``: its lane inputs and outputs, on the
    host."""
    real = kt.traverse

    def rec(tree, segs, pred, cb, carry=None, **kw):
        tr = real(tree, segs, pred, cb, carry=carry, **kw)
        root = kw.get("root")
        log.append(dict(
            kind=type(cb).__name__, q=pred.pts.cpu(),
            root=None if root is None else root.cpu(),
            acc0=None if carry is None else carry.acc.cpu(),
            acc=tr.acc.cpu(), hits=tr.hits.cpu(), evals=tr.evals.cpu()))
        return tr
    kt.traverse = rec
    try:
        yield log
    finally:
        kt.traverse = real


def _same_walks(card: list, host: list, what: str) -> int:
    """Each of the card's walks (the walk kernel) against the host's walk
    at the same point of the same protocol (the plain engine): equal
    inputs, then equal acc, hits and evals."""
    check(len(card) == len(host), f"{what}: {len(card)} walks on the card, "
                                  f"{len(host)} on the host")
    for i, (a, b) in enumerate(zip(card, host)):
        for key in ("kind", "q", "root", "acc0", "acc", "hits", "evals"):
            x, y = a[key], b[key]
            same = (x == y if not isinstance(x, torch.Tensor) else
                    x.dtype == y.dtype and torch.equal(x, y))
            check(same, f"{what}: walk {i} ({a['kind']}): {key} differs "
                        f"between the walk kernel and the plain engine")
    return len(card)


def lattice(n: int, d: int, g: int, seed: int) -> np.ndarray:
    """n points drawn (with repeats) from the integer lattice [0, g)^d, as
    float32. Below g = 2048 at d = 2 every squared distance is an exact
    integer in both arithmetic forms (the walk's sum of squared differences
    and the tiles' norm form, whose norms stay below 2^24), so with a
    non-integer eps^2 no pair can round across the boundary: the tiled and
    tree backends must agree exactly. (Uniform points separated by a band
    of eps^2 do not do at large n: the norm form's rounding error is
    about an ulp of |q|^2 + |r|^2, several per cent of a small eps^2.)"""
    rng = np.random.default_rng(seed)
    return rng.integers(0, g, size=(n, d)).astype(np.float32)


def _sentinel_tiles() -> float:
    """Both tile kernels against their plain versions on blocks padded with
    sentinel rows (1e30), as the ring's trailing shard holds them: real
    queries against padded references, sentinel-only blocks both ways.
    Their squares overflow to inf and the norm form gives NaN; every
    comparison must stay false."""
    err = 0.0
    g = torch.Generator(device="cpu").manual_seed(21)
    for d in (2, 3):
        real = torch.rand(400, d, generator=g)
        pad = torch.full((113, d), 1e30)
        blocks = [torch.cat([real, pad]), pad[:64], real[:7]]
        for q in blocks:
            for r in blocks:
                lab = torch.randint(0, 1000, (r.shape[0],), generator=g,
                                    dtype=torch.int32)
                mask = torch.rand(r.shape[0], generator=g) < 0.7
                qc, rc = q.to(DEV), r.to(DEV)
                got = [pairwise.pairwise_count(qc, rc, 0.05),
                       *pairwise.pairwise_minlabel(qc, rc, lab.to(DEV),
                                                   mask.to(DEV), 0.05)]
                want = [ref.pairwise_count_ref(q, r, 0.05),
                        *ref.pairwise_minlabel_ref(q, r, lab, mask, 0.05)]
                e = max_abs_err([(a.cpu(), b) for a, b in zip(got, want)])
                check(e == 0.0, f"tiles on sentinel-padded blocks d={d} "
                                f"({q.shape[0]} x {r.shape[0]}): the "
                                f"kernels differ from the plain versions")
                err = max(err, e)
    return err


def phase_sharded_check() -> float:
    """The sharded tree path on the card's local mesh against the same call
    on the host (the walks' plain versions): labels, core mask, n_sweeps
    and distance_evals byte-equal, and every walk of the run held against
    the host's walk at the same point of the protocol (the walk kernel on
    a forest of shards, against the plain engine). Then the tile kernels
    on sentinel-padded blocks. Launches here do not count."""
    from repro_torch.distributed import ring_dbscan as rd, sharding
    rng = np.random.default_rng(17)
    cases = []
    for d, eps in SHARDED_CHECK:
        pts = rng.uniform(0, 1, (SHARDED_CHECK_N, d)).astype(np.float32)
        cases += [(pts, eps, p) for p in SHARDED_CHECK_P]
    n_wide, p_wide, eps_wide = SHARDED_WIDE
    for d in (2, 3):
        pts = rng.uniform(0, 1, (n_wide, d)).astype(np.float32)
        cases.append((pts, eps_wide[d], p_wide))
    n_walks = 0
    for pts, eps, p in cases:
        n, d = pts.shape
        card_log, host_log = [], []
        with recorded_walks(card_log):
            a, sa = rd.tree_dbscan_sharded(pts, eps, 5,
                                           mesh=sharding.LocalMesh(p),
                                           with_stats=True)
        with recorded_walks(host_log):
            b, sb = rd.tree_dbscan_sharded(pts, eps, 5,
                                           mesh=sharding.LocalMesh(p),
                                           with_stats=True, device="cpu")
        what = f"sharded n={n} d={d} P={p}"
        check(a.labels.device.type == "cuda", f"{what}: ran off the card")
        check(torch.equal(a.labels.cpu(), b.labels)
              and torch.equal(a.core_mask.cpu(), b.core_mask)
              and (a.n_clusters, a.n_sweeps) == (b.n_clusters, b.n_sweeps)
              and sa == sb, f"{what}: the card differs from the host "
                            f"({sa} vs {sb})")
        n_walks += _same_walks(card_log, host_log, what)
        say("sharded-check", n=n, d=d, P=p, n_sweeps=a.n_sweeps,
            n_clusters=a.n_clusters, distance_evals=sa["distance_evals"],
            walks=len(card_log), sentinel_only_shards=(
                sa["n_pad"] - n) // (sa["n_pad"] // p), ok=True)
    err = _sentinel_tiles()
    say("sharded-check", walks_held=n_walks, tiles_on_sentinels="exact",
        ok=True)
    return err


def _sharded_once(pts, eps, mp, p):
    from repro_torch.distributed import ring_dbscan as rd, sharding
    return rd.tree_dbscan_sharded(pts, eps, mp, mesh=sharding.LocalMesh(p),
                                  with_stats=True)


def run_sharded() -> dict:
    """[sharded]: tree_dbscan_sharded at full size on SHARDED_P shards of a
    local mesh on the card; a cold run, then a warm one timed by CUDA
    events (each builds its shards' indexes, as the reference's does).
    The index build alone is timed apart, on the host clock after a
    synchronise."""
    from repro_torch.distributed import ring_dbscan as rd, sharding
    dset, n, eps, mp = SHARDED
    pts = pointclouds.load(dset, n)
    res, st = _sharded_once(pts, eps, mp, SHARDED_P)        # cold
    before = counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res, st = _sharded_once(pts, eps, mp, SHARDED_P)
    end.record()
    torch.cuda.synchronize()
    warm_ms = start.elapsed_time(end)
    one = {k: v - before[k] for k, v in counts().items()}
    # the index build of one run: every shard's LBVH, the forest, its
    # packed layout
    mesh = sharding.LocalMesh(SHARDED_P)
    x = repro_torch.core.dispatch.as_points(pts, DEV)
    pts_pad, _, n_pad = rd._pad(x, SHARDED_P)
    prog = rd.ShardedProgram(mesh, "data", n, n_pad, eps, mp)
    local = rd._slabs(mesh, "data", pts_pad, prog.n_loc)
    _, valid = prog.slab_ids(DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rd.Forest([rd.ShardIndex(a, v) for a, v in zip(local, valid)])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    wire = roofline.collective_wire_bytes(mesh.collectives, SHARDED_P)
    say("sharded", dataset=dset, n=n, d=pts.shape[1], eps=eps, min_pts=mp,
        shards=SHARDED_P, warm_ms=f"{warm_ms:.1f}",
        index_build_s=f"{build_s:.3f}", n_sweeps=st["n_sweeps"],
        n_clusters=res.n_clusters, distance_evals=st["distance_evals"],
        ring_distance_evals=st["ring_distance_evals"],
        evals_share_of_ring=f"{st['distance_evals'] / st['ring_distance_evals']:.3g}",
        walk_launches_a_run=one["walk"],
        plain_walks_a_run=one["plain_walk_runs"])
    return dict(pts=pts, res=res, stats=st, warm_ms=warm_ms,
                build_s=build_s, one=one, wire=wire)


def check_sharded(out: dict, seen: dict) -> None:
    """[sharded]'s result against single-device fdbscan on the card: core
    mask byte-equal and the same partition of the core points."""
    dset, n, eps, mp = SHARDED
    check(seen["walk"] > 0 and seen["plain_walk_runs"] == 0,
          f"sharded: {seen['walk']} walk launches, "
          f"{seen['plain_walk_runs']} plain walks")
    res = out["res"]
    check_result(res, n, "sharded")
    check(res.backend == "sharded", f"sharded: backend {res.backend}")
    ref_res = repro_torch.dbscan(out["pts"], eps, mp, algorithm="fdbscan")
    check(torch.equal(res.core_mask, ref_res.core_mask),
          "sharded: core mask differs from single-device fdbscan")
    check(same_core_partition(res, ref_res),
          "sharded: core partition differs from single-device fdbscan")
    check(out["stats"]["distance_evals"] * 5
          < out["stats"]["ring_distance_evals"],
          "sharded: the tree path did not beat the ring's work by 5x")
    say("check", path="sharded", vs="fdbscan (single device)", ok=True,
        core=int(res.core_mask.sum()), n_clusters=res.n_clusters)


def run_ring() -> dict:
    """[ring]: ring_dbscan at RING_P shards of a local mesh on the card
    (both tile kernels), RING's lattice points."""
    from repro_torch.distributed import ring_dbscan as rd, sharding
    n, d, g, eps, mp = RING
    pts = lattice(n, d, g, seed=23)
    mesh = sharding.LocalMesh(RING_P)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = rd.ring_dbscan(pts, eps, mp, mesh=mesh)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    say("ring", n=n, d=d, lattice=g, eps=eps, min_pts=mp, shards=RING_P,
        ms=f"{ms:.1f}", n_sweeps=res.n_sweeps, n_clusters=res.n_clusters,
        wire_bytes=roofline.collective_wire_bytes(mesh.collectives,
                                                  RING_P)["total"])
    return dict(pts=pts, res=res, ms=ms)


def check_ring(out: dict, seen: dict) -> None:
    """[ring]'s launches (a count tile a shard a step, a min-label tile a
    shard a step of every sweep and the border pass) and its result
    against single-device fdbscan on the card."""
    n, d, _, eps, mp = RING
    res = out["res"]
    steps = RING_P * RING_P
    check(seen["pairwise_count"] == steps
          and seen["pairwise_minlabel"] == steps * (res.n_sweeps + 1),
          f"ring: {seen['pairwise_count']} count and "
          f"{seen['pairwise_minlabel']} min-label launches for "
          f"{res.n_sweeps} sweeps on {RING_P} shards")
    check(seen["walk"] == 0 and seen["plain_walk_runs"] == 0,
          "ring: a walk ran on the dense ring")
    check_result(res, n, "ring")
    ref_res = repro_torch.dbscan(out["pts"], eps, mp, algorithm="fdbscan")
    check(same_core_partition(res, ref_res),
          "ring: core mask or core partition differs from single-device "
          "fdbscan")
    say("check", path="ring", vs="fdbscan (single device)", ok=True,
        count_launches=seen["pairwise_count"],
        minlabel_launches=seen["pairwise_minlabel"])


def mesh_group_worker(rank: int, workdir: str) -> None:
    """One rank of [mesh-group]: a gloo group of MESH_GROUP_RANKS processes
    on the one card (NCCL refuses two ranks on one device, so the group
    mesh stages its collectives through host buffers); the sharded path
    and the dense ring on the group mesh; results and this process's
    launch counts to ``workdir``."""
    import torch.distributed as dist
    from repro_torch.distributed import ring_dbscan as rd
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=MESH_GROUP_RANKS, rank=rank)
    dset, n, eps, mp = MESH_GROUP
    pts = pointclouds.load(dset, n)
    mesh = lmesh.make_host_mesh()
    reset_counts()
    res, st = rd.tree_dbscan_sharded(pts, eps, mp, mesh=mesh,
                                     with_stats=True)
    ring = rd.ring_dbscan(pts, eps, mp, mesh=mesh)
    torch.cuda.synchronize()
    c = counts()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"),
             labels=res.labels.cpu().numpy(),
             core=res.core_mask.cpu().numpy(),
             meta=np.asarray([res.n_clusters, res.n_sweeps,
                              st["distance_evals"], st["ring_distance_evals"],
                              st["n_pad"]], np.int64),
             ring_labels=ring.labels.cpu().numpy(),
             ring_core=ring.core_mask.cpu().numpy(),
             ring_meta=np.asarray([ring.n_clusters, ring.n_sweeps]),
             counts=np.asarray([c["walk"], c["plain_walk_runs"],
                                c["pairwise_count"], c["pairwise_minlabel"]]),
             device=np.asarray(str(res.labels.device)),
             mesh=np.asarray(type(mesh).__name__ + " " + mesh.backend))
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh_group(workdir: str) -> dict:
    """[mesh-group]: MESH_GROUP_RANKS processes, one shard each, against
    the local mesh at the same shard count in this process: labels, core,
    n_sweeps and the statistics byte-equal, the ring's too. Returns the
    ranks' summed launch counts (they add to the kernel line's)."""
    from repro_torch.distributed import ring_dbscan as rd, sharding
    dset, n, eps, mp = MESH_GROUP
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--mesh-group-rank", str(r), "--mesh-group-dir", workdir],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(MESH_GROUP_RANKS)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"mesh-group rank {r} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    group_s = time.perf_counter() - t0
    pts = pointclouds.load(dset, n)
    mesh = sharding.LocalMesh(MESH_GROUP_RANKS)
    want, st = rd.tree_dbscan_sharded(pts, eps, mp, mesh=mesh,
                                      with_stats=True)
    ring = rd.ring_dbscan(pts, eps, mp,
                          mesh=sharding.LocalMesh(MESH_GROUP_RANKS))
    total = np.zeros(4, np.int64)
    for r in range(MESH_GROUP_RANKS):
        got = np.load(os.path.join(workdir, f"rank{r}.npz"))
        check(str(got["device"]).startswith("cuda")
              and str(got["mesh"]) == "GroupMesh gloo",
              f"mesh-group rank {r}: ran on {got['device']} over "
              f"{got['mesh']}")
        check(np.array_equal(got["labels"], want.labels.cpu().numpy())
              and np.array_equal(got["core"], want.core_mask.cpu().numpy())
              and got["meta"].tolist() == [
                  want.n_clusters, want.n_sweeps, st["distance_evals"],
                  st["ring_distance_evals"], st["n_pad"]],
              f"mesh-group rank {r}: the sharded result differs from the "
              f"local mesh's")
        check(np.array_equal(got["ring_labels"], ring.labels.cpu().numpy())
              and np.array_equal(got["ring_core"],
                                 ring.core_mask.cpu().numpy())
              and got["ring_meta"].tolist() == [ring.n_clusters,
                                                ring.n_sweeps],
              f"mesh-group rank {r}: the ring differs from the local mesh's")
        check(got["counts"][0] > 0 and got["counts"][1] == 0,
              f"mesh-group rank {r}: {got['counts'][0]} walk launches, "
              f"{got['counts'][1]} plain walks")
        total += got["counts"]
    say("mesh-group", ranks=MESH_GROUP_RANKS, backend="gloo", dataset=dset,
        n=n, n_sweeps=want.n_sweeps, n_clusters=want.n_clusters,
        walk_launches=int(total[0]), count_launches=int(total[2]),
        minlabel_launches=int(total[3]), group_s=f"{group_s:.1f}",
        vs=f"local mesh P={MESH_GROUP_RANKS}", ok=True)
    return {"walk": int(total[0]), "pairwise_count": int(total[2]),
            "pairwise_minlabel": int(total[3])}


def timed(phase: str, fn, *args):
    """``fn(*args)``, with a line giving its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    say("phase-time", name=phase, seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a per-kernel device time breakdown")
    # one rank of [mesh-group], started by the phase itself
    ap.add_argument("--mesh-group-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-group-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_group_rank is not None:
        mesh_group_worker(args.mesh_group_rank, args.mesh_group_dir)
        return
    t_all = time.perf_counter()

    phase_environment()
    walk_err = timed("walk-check", phase_walk_check)
    tune_err = timed("tune-check", phase_tune_check)
    tile_t = timed("tile-check", phase_tile_check)
    knn_err = timed("knn-check", phase_knn_check)

    reset_counts()
    runs = timed("main", run_main_path)
    seen = counts()
    say("counts", path="dbscan", **seen)
    check_main_path(runs, seen)
    main_err, walk_t = timed("main-walk-check", phase_main_walk_check, runs)
    timed("walk-totals", phase_walk_totals, runs)

    reset_counts()
    nb = timed("neighbors", run_neighbors)
    seen_nb = counts()
    say("counts", path="neighbors", **seen_nb)
    check_neighbors(nb, seen_nb)
    timed("radius-visit", phase_radius_visit)
    knn_t = timed("knn-time", phase_knn_timing, nb)
    del nb
    timed("obs", phase_obs, runs)

    reset_counts()
    with tempfile.TemporaryDirectory() as workdir:
        st = timed("stream", run_stream, workdir)
    seen_st = counts()
    say("counts", path="stream", **seen_st)
    timed("stream-check", check_stream, st, seen_st)
    del st
    timed("stream-parity", phase_stream_parity)

    reset_counts()
    with tempfile.TemporaryDirectory() as workdir:
        sv = timed("serve", run_serve, workdir)
    seen_sv = counts()
    say("counts", path="serve", **seen_sv)
    timed("serve-check", check_serve, sv, seen_sv)
    del sv
    with tempfile.TemporaryDirectory() as workdir:
        timed("serve-cli", phase_serve_cli, workdir)
    reset_counts()
    timed("tune", phase_tune, runs)
    seen_tu = counts()
    say("counts", path="tune", **seen_tu)
    check(seen_tu["walk"] > 0 and seen_tu["plain_walk_runs"] == 0,
          f"tune: {seen_tu['walk']} walk launches, "
          f"{seen_tu['plain_walk_runs']} plain walks")
    sh_err = timed("sharded-check", phase_sharded_check)
    reset_counts()
    sh = timed("sharded", run_sharded)
    seen_sh = counts()
    say("counts", path="sharded", **seen_sh)
    timed("sharded-verify", check_sharded, sh, seen_sh)
    del sh
    reset_counts()
    rg = timed("ring", run_ring)
    seen_rg = counts()
    say("counts", path="ring", **seen_rg)
    timed("ring-verify", check_ring, rg, seen_rg)
    del rg
    with tempfile.TemporaryDirectory() as workdir:
        seen_mg = timed("mesh-group", phase_mesh_group, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        timed("cluster-cli", phase_cluster_cli, workdir)
    timed("degenerate", phase_degenerate)
    if args.profile:
        phase_profile(runs)
    say("total-time", seconds=f"{time.perf_counter() - t_all:.1f}")
    walk_t["max_abs_err"] = max(walk_err, main_err, tune_err)
    knn_t["max_abs_err"] = max(knn_err, knn_t["max_abs_err"])
    for name in ("pairwise_count", "pairwise_minlabel"):
        tile_t[name]["max_abs_err"] = max(tile_t[name]["max_abs_err"],
                                          sh_err)

    csrc = "src/repro_torch/csrc"
    kernels = [
        dict(name="walk", route="cuda", source=f"{csrc}/walk.cu",
             replaces="src/repro/kernels/traverse.py:98",
             launches=(seen["walk"] + seen_st["walk"] + seen_sv["walk"]
                       + seen_tu["walk"] + seen_sh["walk"]
                       + seen_mg["walk"]),
             **walk_t),
        dict(name="pairwise_count", route="cuda",
             source=f"{csrc}/pairwise.cu",
             replaces="src/repro/kernels/pairwise.py:67",
             launches=(seen["pairwise_count"] + seen_rg["pairwise_count"]
                       + seen_mg["pairwise_count"]),
             **tile_t["pairwise_count"]),
        dict(name="pairwise_minlabel", route="cuda",
             source=f"{csrc}/pairwise.cu",
             replaces="src/repro/kernels/pairwise.py:81",
             launches=(seen["pairwise_minlabel"]
                       + seen_rg["pairwise_minlabel"]
                       + seen_mg["pairwise_minlabel"]),
             **tile_t["pairwise_minlabel"]),
        dict(name="knn", route="cuda", source=f"{csrc}/knn.cu",
             replaces="none: no Pallas kernel (the reference's k-NN is an "
                      "XLA while-loop, src/repro/core/traversal.py:663)",
             launches=seen_nb["knn"], **knn_t),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
