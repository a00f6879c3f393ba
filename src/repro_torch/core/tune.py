"""Per-plan tuning of the ``pallas-tree`` backend's walks (the reference's
``repro.core.tune``, same names, defaults and decisions on the CPU).

A plan's :class:`TuneState` picks, per clustering phase (``first_pass`` /
``sweep`` / ``border``):

  * the **engine** — ``"pallas"`` (the walk entry
    ``repro_torch.kernels.traverse.traverse``: the walk kernel on the card,
    the plain engine on the CPU at the phase's ``unroll``) or
    ``"reference"`` (the plain engine at its default unroll), with
    ``"auto"`` choosing by the border's share of lanes;
  * the **lane tile** and **unroll** from :data:`TUNE_LANE_TILES` x
    :data:`TUNE_UNROLLS`, capped by the reference's VMEM budget;
  * the **lane order** (``traversal.lane_sort_key``): ``"none"``,
    ``"morton"`` or ``"depth"`` (deepest first, by the per-query trips the
    fused first pass measured, stored by :meth:`TuneState.calibrate`).

Every choice changes only the schedule: labels, core masks, sweep counts,
``acc``, ``hits`` and ``evals`` are the same under every config, and
``iters`` is the same at the same unroll.

On the card the choices mean other things than on a TPU. The lane tile is
the walk kernel's threads per block (its persistent threads refill lanes,
so a block does not wait for its slowest lane); the unroll only sets the
trip count ``iters`` reports; and every phase runs the kernel, never the
plain engine, which takes about 2 ms a step there. So the CUDA branch of
:func:`heuristic` names the kernel for all three phases with no
small-frontier fallback (``min_lanes`` 0, ``border_min_frac`` 0.0) — the
reference's GPU branch would send small frontiers to its engine — and a
CUDA phase that resolves to ``"reference"`` raises. Its lane tile is 128
and its unroll 4 (the kernel's defaults, so ``REPRO_TUNE=off`` and the
heuristic report the same counters); its lane order,
:data:`CUDA_REORDER`, was chosen by measurement (``PERF.md``, section 6).

Modes (``REPRO_TUNE``): ``off`` — the pin :data:`PINNED`; ``heuristic``
(the default) — :func:`heuristic`; ``search`` — :func:`search`, a measured
per-phase choice cached under :func:`stats_key` in the dispatcher's plan
LRU.
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Any, NamedTuple

import numpy as np
import torch

from . import traversal

#: Candidate grid of the reference (its conformance test sweeps all of it).
TUNE_LANE_TILES = (64, 128, 256, 512)
TUNE_UNROLLS = (1, 2, 4, 8)

_SEARCH_LANE_TILES = (128, 256, 512)
_SEARCH_UNROLLS = (1, 4)

#: The reference's VMEM budget for whole-array index residency + lane
#: state; kept so the CPU decisions (the lane tiles it allows) are its.
VMEM_BUDGET_BYTES = 8 << 20

#: Per-lane walk state footprint of the reference's kernel, in bytes.
_LANE_STATE_BYTES = 64

#: The card's lane order for the first pass and the sweeps (measured on an
#: H100: ``"depth"`` against ``"none"``, PERF.md section 6).
CUDA_REORDER = "none"


class PhaseConfig(NamedTuple):
    """How one clustering phase executes its traversals."""
    engine: str = "pallas"      # "pallas" | "reference" | "auto"
    lane_tile: int = 128
    unroll: int = 4
    reorder: str = "none"       # "none" | "morton" | "depth"


class TunedConfig(NamedTuple):
    """A full per-plan tuning decision (one PhaseConfig per phase).

    ``min_lanes``: kernel phases whose lane count (the reference's padded
    count) falls below this run the reference engine instead.
    ``border_min_frac``: an ``engine="auto"`` border phase picks the kernel
    only when the non-core fraction reaches this.
    """
    first_pass: PhaseConfig = PhaseConfig()
    sweep: PhaseConfig = PhaseConfig()
    border: PhaseConfig = PhaseConfig()
    min_lanes: int = 0
    border_min_frac: float = 0.0
    source: str = "pinned"


#: REPRO_TUNE=off — the fixed configuration: the kernel at (128, 4) with no
#: reordering in every phase.
PINNED = TunedConfig()


def mode() -> str:
    """Resolve the REPRO_TUNE environment variable to a tuner mode."""
    m = os.environ.get("REPRO_TUNE", "").strip().lower()
    if m in ("off", "0", "none", "pinned"):
        return "off"
    if m == "search":
        return "search"
    return "heuristic"


_ENGINE_FNS: dict[PhaseConfig, Any] = {}


def engine_fn(cfg: PhaseConfig):
    """The walk callable for ``cfg``, with a stable identity per config.

    ``"reference"`` is the plain engine (``traversal.traverse``, at its
    default unroll); any other engine is the walk entry
    ``repro_torch.kernels.traverse.traverse`` at the phase's lane tile,
    unroll and lane order — the entry itself for the default config
    (128, 4, ``"none"``).
    """
    if cfg.engine == "reference":
        return traversal.traverse
    fn = _ENGINE_FNS.get(cfg)
    if fn is None:
        from repro_torch.kernels import traverse as kt
        if (cfg.lane_tile == kt.LANE_TILE and cfg.unroll == kt.PALLAS_UNROLL
                and cfg.reorder == "none"):
            fn = kt.traverse
        else:
            fn = partial(kt.traverse, lane_tile=cfg.lane_tile,
                         unroll=cfg.unroll, reorder=cfg.reorder)
        _ENGINE_FNS[cfg] = fn
    return fn


def lane_tiles_within_budget(index_bytes: int,
                             candidates=TUNE_LANE_TILES) -> tuple:
    """Candidate lane tiles whose state + index fit the VMEM budget."""
    fit = tuple(t for t in candidates
                if index_bytes + t * _LANE_STATE_BYTES <= VMEM_BUDGET_BYTES)
    return fit or candidates[:1]


class TuneState:
    """Mutable tuning state attached to a dispatcher Plan.

    Holds the (immutable) :class:`TunedConfig` plus the lazily calibrated
    depth oracle: after the first fused pass, ``calibrate`` stores that
    pass's per-query loop trips (``Trace.iters``, indexed by sorted point
    id), and later ``reorder="depth"`` walks sort lanes by descending
    depth. The oracle only affects lane order, never a result.
    """

    def __init__(self, config: TunedConfig):
        self.config = config
        self.depth_rank = None
        self.info: dict = {}

    def phase(self, name: str, *, n_lanes: int | None = None,
              n: int | None = None) -> PhaseConfig:
        """Resolve the phase's config against the actual lane shape."""
        cfg: PhaseConfig = getattr(self.config, name)
        if cfg.engine == "auto":
            frac = 1.0 if not n else (n_lanes or 0) / n
            cfg = cfg._replace(
                engine="pallas" if frac >= self.config.border_min_frac
                else "reference")
        if (cfg.engine == "pallas" and n_lanes is not None
                and n_lanes < self.config.min_lanes):
            cfg = cfg._replace(engine="reference")
        return cfg

    def rank_for(self, cfg: PhaseConfig):
        """The depth oracle, iff this phase's kernel wants it."""
        if cfg.engine == "pallas" and cfg.reorder == "depth":
            return self.depth_rank
        return None

    def calibrate(self, iters) -> None:
        """Store the fused pass's per-query walk depth as the oracle."""
        if self.depth_rank is None and self.config.source != "pinned":
            self.depth_rank = iters

    def describe(self) -> dict:
        """JSON-safe record of the decision (obs gauge, CLI, smoke run)."""
        out = {"source": self.config.source,
               "min_lanes": int(self.config.min_lanes),
               "border_min_frac": float(self.config.border_min_frac),
               "calibrated": self.depth_rank is not None}
        for name in ("first_pass", "sweep", "border"):
            cfg: PhaseConfig = getattr(self.config, name)
            out[name] = {"engine": cfg.engine,
                         "lane_tile": int(cfg.lane_tile),
                         "unroll": int(cfg.unroll),
                         "reorder": cfg.reorder}
        out.update(self.info)
        return out


# Bytes an element of each index field takes in the reference (its arrays
# are int32/uint32/float32, and bool): the port keeps Morton codes as int64,
# so its own itemsizes would count other bytes for the same points.
def _ref_itemsize(t: torch.Tensor) -> int:
    return 1 if t.dtype == torch.bool else 4


def _index_bytes(segs, tree) -> int:
    """Whole-array footprint of the (segments, tree) index in the
    reference's dtypes (its VMEM residency), the same bytes for the same
    points as the reference's ``_index_bytes``."""
    total = 0
    for holder in (segs, tree):
        if holder is None:
            continue
        for leaf in holder:
            if isinstance(leaf, torch.Tensor):
                total += leaf.numel() * _ref_itemsize(leaf)
    return total


def stats_key(segs, eps: float, min_pts: int) -> tuple:
    """Cheap index stats bucketed into a search-cache key: log2 buckets of
    n, leaf occupancy and eps-cell density, plus d and min_pts (the
    reference's key for the same points)."""
    n = int(segs.n_points)
    m = max(int(segs.n_segments), 1)
    d = int(segs.pts.shape[1])
    occupancy = n / m
    density = occupancy
    if eps > 0:
        from . import fdbscan
        keys = fdbscan._cell_keys(segs.pts, eps)
        density = n / max(int(torch.unique(keys).numel()), 1)

    def bucket(x: float) -> int:
        return int(round(np.log2(max(x, 1.0))))

    return (d, bucket(n), bucket(occupancy + 1), bucket(density + 1),
            int(min_pts))


def heuristic(segs, tree) -> TunedConfig:
    """Stats-driven config, no measurement.

    CPU index: the reference's non-TPU decision — the widest in-budget lane
    tile at unroll 1, ``"depth"`` order for the first pass and sweeps, an
    ``"auto"`` border at ``min(256, widest)``, and the small-frontier
    fallbacks (``min_lanes`` 256, ``border_min_frac`` 0.9).

    CUDA index: the walk kernel in every phase at (128, 4), the first pass
    and sweeps in :data:`CUDA_REORDER` order, the border in launch order,
    and no fallback (see the module docstring).
    """
    if segs.pts.device.type == "cuda":
        fp = PhaseConfig("pallas", 128, 4, CUDA_REORDER)
        sw = PhaseConfig("pallas", 128, 4, CUDA_REORDER)
        bd = PhaseConfig("pallas", 128, 4, "none")
        return TunedConfig(first_pass=fp, sweep=sw, border=bd,
                           min_lanes=0, border_min_frac=0.0,
                           source="heuristic")
    tiles = lane_tiles_within_budget(_index_bytes(segs, tree))
    wide = max(tiles)
    fp = PhaseConfig("pallas", wide, 1, "depth")
    sw = PhaseConfig("pallas", wide, 1, "depth")
    bd = PhaseConfig("auto", min(256, wide), 1, "none")
    return TunedConfig(first_pass=fp, sweep=sw, border=bd,
                       min_lanes=256, border_min_frac=0.9,
                       source="heuristic")


def _time_best(fn, cuda: bool, repeats: int = 3) -> float:
    """Best-of-N seconds after a warm-up call; on the card each call is
    bracketed by a synchronisation, so the host clock reads the device's
    work."""
    def call():
        fn()
        if cuda:
            torch.cuda.synchronize()

    call()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


def search(segs, tree, eps: float, min_pts: int, *, walk_index=None
           ) -> tuple[TunedConfig, dict]:
    """Measured per-phase A/B over the candidate grid.

    Runs the fused first pass once to obtain the workload's real phase
    shapes (core mask, first-sweep lanes, border lanes) and the depth
    oracle, then times each candidate on those shapes and keeps the
    per-phase winner (every candidate gives the same results). The caller
    caches ``(config, info)`` under :func:`stats_key`.

    On the card the candidates are the kernel alone (no ``"reference"``:
    no phase runs the plain engine there) at one unroll
    (``PALLAS_UNROLL``: the unroll only sets the reported trips) and every
    search lane tile (the kernel keeps no index on chip, so the VMEM
    budget does not cap them), each timed with a synchronisation around
    it; ``walk_index`` is the index's packed layout (packed here when not
    given).
    """
    from repro_torch.kernels import traverse as kt
    from . import fdbscan

    cuda = segs.pts.device.type == "cuda"
    if cuda and walk_index is None:
        from repro_torch.kernels.walkpack import pack_index
        walk_index = pack_index(tree, segs)
    base = heuristic(segs, tree)
    tiles = (_SEARCH_LANE_TILES if cuda else
             lane_tiles_within_budget(_index_bytes(segs, tree),
                                      _SEARCH_LANE_TILES))
    unrolls = (kt.PALLAS_UNROLL,) if cuda else _SEARCH_UNROLLS
    info: dict = {}
    wkw = {} if walk_index is None else {"walk_index": walk_index}

    core, labels0, vals0, absorbed, first = fdbscan._fused_first_pass(
        tree, segs, eps, min_pts, walk_index=walk_index)
    rank = first.iters
    info["mean_hits"] = float(first.hits.float().mean())

    def label(c: PhaseConfig) -> str:
        return (c.engine if c.engine == "reference" else
                f"pallas/{c.lane_tile}x{c.unroll}/{c.reorder}")

    def candidates(reorder: str):
        if not cuda:
            yield PhaseConfig("reference", 0, 0, "none")
        for lt in tiles:
            for k in unrolls:
                yield PhaseConfig("pallas", lt, k, reorder)

    def pick(reorder: str, run) -> tuple[PhaseConfig, dict]:
        timings = {}
        for cand in candidates(reorder):
            fn = engine_fn(cand)
            kw = ({"depth_rank": rank}
                  if cand.engine == "pallas" and cand.reorder == "depth"
                  else {})
            if cand.engine == "pallas":
                kw.update(wkw)
            timings[label(cand)] = _time_best(lambda: run(fn, kw), cuda)
        best_label = min(timings, key=timings.get)
        best = next(c for c in candidates(reorder) if label(c) == best_label)
        return best, timings

    # -- first pass: the full fused count+minlabel walk -------------------
    def run_first(fn, kw):
        phase = {"engine": fn}
        if "depth_rank" in kw:
            phase["depth_rank"] = kw["depth_rank"]
        fdbscan._fused_first_pass(tree, segs, eps, min_pts, phase=phase,
                                  walk_index=kw.get("walk_index"))

    fp, t_fp = pick("depth", run_first)

    # -- sweep: the first (widest) min-label sweep shape ------------------
    ids_sweep = fdbscan._compact_ids(core)
    nm_core = fdbscan._frontier_node_mask(tree, segs, core)

    def run_sweep(fn, kw):
        fn(tree, segs,
           traversal.intersects(traversal.sphere(eps), ids=ids_sweep),
           traversal.MinLabelVisitor(labels0, core), node_mask=nm_core, **kw)

    sw, t_sw = pick("depth", run_sweep)

    # -- border: the non-core gather shape --------------------------------
    ids_border = fdbscan._compact_ids(~core)
    border_vals = torch.where(core, labels0, traversal.INT_MAX)

    def run_border(fn, kw):
        fn(tree, segs,
           traversal.intersects(traversal.sphere(eps), ids=ids_border),
           traversal.MinLabelVisitor(border_vals, core), node_mask=nm_core,
           **kw)

    bd, t_bd = pick("none", run_border)

    info["timings"] = {"first_pass": t_fp, "sweep": t_sw, "border": t_bd}
    cfg = TunedConfig(first_pass=fp, sweep=sw, border=bd,
                      min_lanes=base.min_lanes, border_min_frac=0.0,
                      source="search")
    return cfg, info


def config_for(segs, tree, eps: float, min_pts: int,
               mode_name: str | None = None) -> TunedConfig:
    """The non-measured config for the active (or given) mode."""
    m = mode_name or mode()
    if m == "off":
        return PINNED
    return heuristic(segs, tree)
