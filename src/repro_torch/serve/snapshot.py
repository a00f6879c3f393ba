"""Immutable versioned index snapshots for the serving plane (DESIGN.md §13).

The port of ``repro.serve.snapshot``, exact to it: the same cell-summary
grid over exactly the active points, the same float64 box classification
of the candidate cells, the same exact float32 pass over the partial
cells, and byte-equal ``QueryResult``s on the same frozen state.

Geometry (paper §3's eps-grid, specialized to read-only serving):

  * cell width ``w = eps / sqrt(d)`` — the cell diagonal is exactly eps,
    so every probe's eps-ball is covered by the 5^d block of cells at
    offsets in [-2, 2]^d around its own cell;
  * points are sorted by row-major cell key, with per-unique-cell
    ``counts`` and ``core-min-label`` aggregates (non-core residents carry
    ``INT_MAX`` so the min is over core points only — exactly the
    ``QueryResult.labels`` semantics);
  * per probe, each candidate cell is classified against the eps-ball in
    float64 box arithmetic with a conservative relative margin ``PAD``:
    **inside** (every resident provably within eps under float32
    rounding), **partial** (may contribute), or skipped;
  * a probe needs exact point tests only when the inside-cell count has
    not yet saturated at ``min_pts`` while partial cells exist, or when a
    partial cell could still lower the label minimum. Flagged probes run
    an exact float32 pass over their partial cells only, gathered ragged.

The snapshot lives on the frozen state's device, and ``query`` runs there
and returns host (numpy) arrays, like the streaming handle's. The host
computes what the reference computes on scalars and offsets (``_w``,
``_lo``, ``_eps2``, the margins, the candidate offsets) exactly as the
reference does; the device runs the per-point and per-probe arithmetic one
torch op per numpy op, so every rounding is the reference's:

  * the box classification is float64, ``dmin2 += near * near`` a multiply
    and a separate add; divisions by ``w`` divide by a device tensor (on
    the card a division by a host scalar is a multiply by its reciprocal,
    one rounding off);
  * the exact pass is eager float32, ``(dx*dx + dy*dy) + dz*dz`` with each
    operation rounded on its own (``kernels/ref.py: tile_sum_sq(fma=False)``
    term by term, as numpy's ``(diff * diff).sum(-1)`` rounds; never
    ``.sum(-1)``, ``addcmul`` or ``matmul``). The streaming handle's walk
    rounds as a fused multiply-add chain instead, so snapshot and
    ``StreamingDBSCAN.query`` agree only where no pair lies within
    rounding of eps; the snapshot is held to the reference's snapshot;
  * counts are ``scatter_add`` and the label minimum ``scatter_reduce
    ("amin")``, both independent of order, so the exact pass chunks by the
    points it gathers (not by 256 probes, as the reference does) and the
    result stays identical.

:class:`SnapshotStore` holds the *published* snapshot behind an atomic
reference swap: readers grab the current snapshot with one attribute load
(no lock on the read path) and keep using it for a whole batch even if the
writer publishes newer versions meanwhile — queries are never blocked
behind inserts, merges, or compactions, and a failed rebuild simply never
publishes (the old version keeps serving).
"""
from __future__ import annotations

import itertools
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.validate import check_points
from repro_torch.kernels.ref import tile_sum_sq
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.stream import durability
from repro_torch.stream.index import QueryResult

INT_MAX = 2**31 - 1

# Relative classification margin: boundary-ambiguous cells (within
# eps^2 * PAD of the threshold) are demoted to exact point tests, so
# float32 rounding in the reference distance arithmetic can never
# disagree with a float64 box classification.
PAD = 1e-5

# Candidate-cell offset range per axis: w = eps/sqrt(d) keeps the
# eps-ball inside [-2, 2]^d for d in (2, 3).
_RANGE = 2

# Points gathered per exact-pass chunk (at least one probe/cell pair a
# chunk), bounding the ragged gather's peak memory.
_EXACT_POINTS = 1 << 22


class FrozenState(NamedTuple):
    """What :meth:`repro_torch.stream.StreamingDBSCAN.freeze_view`
    exports: the active points with their serving values, plus the stream
    position. The tensors are copies on the handle's device."""
    pts: torch.Tensor      # (n_active, d) float32, insertion order
    vals: torch.Tensor     # (n_active,) int64: core -> component-min gid
                           # label; non-core -> INT_MAX
    watermark: int         # stream n_points at freeze time
    n_tombstoned: int


def _on(x, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.detach().to(device=device, dtype=dtype).contiguous()


class IndexSnapshot:
    """An immutable, eps-specialized read-only view of the index.

    Built by :func:`freeze` (or :meth:`build`); never mutated afterwards
    — the serving plane swaps whole snapshots, it does not edit them.
    ``device``: where it lives and answers queries; default the device of
    ``pts`` when it is a tensor, else the current CUDA device
    (``RuntimeError`` without one — pass ``device="cpu"``).
    """

    # explicit host syncs of every query so far, all snapshots: the probe
    # pairs' nonzero, the gathered point total, the result copy
    host_syncs = 0
    _syncs_lock = threading.Lock()

    def __init__(self, pts, vals, eps: float, min_pts: int, *,
                 version: int = 0, watermark: int = 0, device=None):
        if eps <= 0:
            raise ValueError(f"snapshot needs eps > 0; got {eps}")
        if min_pts < 1:
            raise ValueError(f"min_pts must be >= 1; got {min_pts}")
        if device is None and isinstance(pts, torch.Tensor):
            device = pts.device
        dev = self.device = dispatch.resolve_device(device)
        pts = _on(pts, torch.float32, dev)
        vals = _on(vals, torch.int64, dev)
        if pts.ndim != 2 or pts.shape[1] not in (2, 3):
            raise ValueError(f"snapshot needs (n, 2|3) points; got "
                             f"{tuple(pts.shape)}")
        if len(vals) != len(pts):
            raise ValueError(f"vals/pts length mismatch: {len(vals)} vs "
                             f"{len(pts)}")
        self.eps = float(eps)
        self.min_pts = int(min_pts)
        self.version = int(version)
        self.watermark = int(watermark)
        self.n_points = len(pts)
        self.d = int(pts.shape[1])
        self._eps2 = np.float32(np.float32(eps) ** 2)
        if self.n_points == 0:
            return
        d = self.d
        self._w = float(eps) / np.sqrt(d)
        self._lo = (pts.min(0).values.cpu().numpy().astype(np.float64)
                    - 3.0 * float(eps))
        self._lo_t = torch.from_numpy(self._lo).to(dev)
        self._w_t = torch.full((d,), self._w, dtype=torch.float64,
                               device=dev)
        cell = torch.floor((pts.double() - self._lo_t) / self._w_t).long()
        # per-axis cell-space extents (+5 slack so every resident's
        # [-2, 2]^d neighborhood stays strictly in range)
        self._nc = cell.max(0).values.cpu().numpy() + 5
        key = cell[:, 0]
        for i in range(1, d):
            key = key * int(self._nc[i]) + cell[:, i]
        self._keys, order = torch.sort(key, stable=True)
        self._pts = pts[order]
        self._vals = vals[order]
        self._uk, self._cnts = torch.unique_consecutive(self._keys,
                                                        return_counts=True)
        self._starts = torch.cumsum(self._cnts, 0) - self._cnts
        cell_of = torch.repeat_interleave(
            torch.arange(len(self._uk), device=dev), self._cnts,
            output_size=self.n_points)
        self._cmin = torch.full((len(self._uk),), INT_MAX, dtype=torch.int64,
                                device=dev).scatter_reduce_(
            0, cell_of, self._vals, "amin")
        # candidate offsets, pruned by the worst-case (corner) box
        # distance — an offset whose nearest box face exceeds eps for
        # every in-cell probe position can never contribute
        w2 = self._w * self._w
        offs = []
        for o in itertools.product(range(-_RANGE, _RANGE + 1), repeat=d):
            near2 = sum(max(abs(oi) - 1, 0) ** 2 for oi in o) * w2
            if near2 <= float(self._eps2) * (1 + PAD):
                offs.append(o)
        self._offs = np.array(offs, np.int64)               # (K, d)
        self._offs_t = torch.from_numpy(self._offs).to(dev)
        if dev.type == "cuda":
            # Complete before anyone holds it: the thread that builds it
            # (the server's writer) and the readers (its query thread) run
            # on different CUDA streams, so a reader must never see tensors
            # whose kernels are still queued on the building stream.
            torch.cuda.current_stream(dev).synchronize()

    # ------------------------------------------------------------------ #

    @classmethod
    def build(cls, state: FrozenState, eps: float, min_pts: int, *,
              version: int = 0) -> "IndexSnapshot":
        """Build a snapshot from a handle's :class:`FrozenState`, on the
        state's device."""
        return cls(state.pts, state.vals, eps, min_pts, version=version,
                   watermark=state.watermark)

    def stats(self) -> dict:
        """Size/occupancy facts for logs and the bench record."""
        return {
            "version": self.version, "n_points": self.n_points,
            "watermark": self.watermark, "d": self.d,
            "eps": self.eps, "min_pts": self.min_pts,
            "n_cells": int(len(self._uk)) if self.n_points else 0,
            "n_offsets": int(len(self._offs)) if self.n_points else 0,
        }

    # ------------------------------------------------------------------ #
    # query                                                              #
    # ------------------------------------------------------------------ #

    def query(self, pts) -> QueryResult:
        """Cluster assignment for probe points against this frozen view.

        The reference snapshot's contract, byte for byte: ``labels`` is
        the component representative of the minimum adjacent core point
        (-1 when none within eps), ``counts`` the eps-neighbor count among
        active residents saturated at ``min_pts``, ``would_be_core``
        whether the probe would be core if inserted now. Host arrays.
        """
        qb = check_points(pts, name="probe points", dims=(2, 3),
                          allow_empty=True)
        qb = np.ascontiguousarray(qb, np.float32)
        k = len(qb)
        if self.n_points and qb.shape[1] != self.d:
            raise ValueError(f"dimensionality mismatch: snapshot is "
                             f"{self.d}-d, got {qb.shape[1]}-d")
        if k == 0 or self.n_points == 0:
            return QueryResult(np.full(k, -1, np.int32),
                               np.zeros(k, np.int32),
                               np.ones(k, bool) if self.min_pts <= 1
                               else np.zeros(k, bool))
        labels, counts = self._query_arrays(qb)
        obs_metrics.inc("serve_snapshot_queries_total")
        return QueryResult(labels=labels, counts=counts,
                           would_be_core=counts + 1 >= self.min_pts)

    def _query_arrays(self, qb: np.ndarray):
        dev, d = self.device, self.d
        q = torch.from_numpy(qb).to(dev)
        B = len(qb)
        q64 = q.double()
        w, mp = self._w, self.min_pts
        qcf = torch.floor((q64 - self._lo_t) / self._w_t)
        # clamp far-out probes into a bounded cell range: anything past
        # the slack band is provably > eps from every resident, and the
        # clamp keeps the in-cell offsets (and box distances) finite and
        # the key arithmetic overflow-free
        nc64 = torch.from_numpy(self._nc.astype(np.float64)).to(dev)
        qc = torch.minimum(torch.clamp_min(qcf, -3.0), nc64 + 3.0).long()
        u = q64 - (qc.double() * w + self._lo_t)         # (B, d)
        eps2_hi = float(self._eps2) * (1 + PAD)
        eps2_lo = float(self._eps2) * (1 - PAD)

        offs = self._offs_t                             # (K, d)
        K = len(offs)
        dmin2 = torch.zeros((B, K), dtype=torch.float64, device=dev)
        dmax2 = torch.zeros((B, K), dtype=torch.float64, device=dev)
        ck = None
        inrange = torch.ones((B, K), dtype=torch.bool, device=dev)
        for i in range(d):
            oi = offs[:, i][None, :]                    # (1, K)
            lo_i = oi.double() * w
            hi_i = (oi + 1).double() * w
            ui = u[:, i][:, None]                       # (B, 1)
            near = torch.clamp_min(torch.maximum(lo_i - ui, ui - hi_i), 0.0)
            far = torch.maximum((ui - lo_i).abs(), (ui - hi_i).abs())
            dmin2 = dmin2 + near * near     # two roundings, as numpy's
            dmax2 = dmax2 + far * far       # `+= near * near`
            ci = qc[:, i][:, None] + oi
            inrange &= (ci >= 0) & (ci < int(self._nc[i]))
            ck = ci if ck is None else ck * int(self._nc[i]) + ci

        idx = torch.searchsorted(self._uk, ck.reshape(-1)).reshape(B, K)
        idx = torch.clamp_max(idx, len(self._uk) - 1)
        present = inrange & (self._uk[idx] == ck)
        ins = present & (dmax2 <= eps2_lo)
        par = present & ~ins & (dmin2 <= eps2_hi)
        cn = self._cnts[idx]
        cm = self._cmin[idx]
        big = torch.full_like(cm, INT_MAX)
        inside_cnt = torch.where(ins, cn, 0).sum(1)
        inside_min = torch.where(ins, cm, big).amin(1)
        partial_min = torch.where(par, cm, big).amin(1)
        # summaries are exact unless a partial cell could still push the
        # count past saturation or lower the label minimum
        need = (((inside_cnt < mp) & par.any(1))
                | (partial_min < inside_min))
        cnt, mn = self._exact(q, par & need[:, None], idx, inside_cnt,
                              inside_min)
        labels = torch.where(mn == INT_MAX, -1, mn)
        counts = torch.clamp_max(cnt, mp)
        host = torch.cat([labels, counts, need.sum()[None]]).cpu().numpy()
        self._note_syncs(1)
        obs_metrics.inc("serve_snapshot_exact_probes_total",
                        float(host[-1]))
        return host[:B].astype(np.int32), host[B:2 * B].astype(np.int32)

    def _exact(self, q, par, idx, inside_cnt, inside_min):
        """Exact float32 point tests over the *partial* cells of flagged
        probes (``par`` holds only those).

        Inside cells are already exactly accounted and skipped cells
        provably contribute nothing. Residents are gathered **ragged**
        (work proportional to the points actually touched), in chunks of
        whole probe/cell pairs of at most ``_EXACT_POINTS`` points. Two
        host syncs when any pair exists: the pairs' ``nonzero`` and the
        gathered point total (the ragged ``repeat_interleave`` sizes)."""
        cnt = inside_cnt.clone()
        mn = inside_min.clone()
        pairs = torch.nonzero(par)                      # host sync
        self._note_syncs(1)
        if len(pairs) == 0:
            return cnt, mn
        bi = pairs[:, 0]
        cells = idx[bi, pairs[:, 1]]
        lens = self._cnts[cells]
        ends = torch.cumsum(lens, 0)
        # position of each gathered point in the sorted residents: its
        # pair's cell start plus its offset inside the pair's run
        shift = self._starts[cells] - (ends - lens)
        ends_h = ends.cpu().numpy()                     # host sync
        self._note_syncs(1)
        p0 = 0
        while p0 < len(ends_h):
            e0 = int(ends_h[p0 - 1]) if p0 else 0
            p1 = max(p0 + 1, int(np.searchsorted(
                ends_h, e0 + _EXACT_POINTS, "right")))
            tot = int(ends_h[p1 - 1]) - e0
            cl = lens[p0:p1]
            probe = torch.repeat_interleave(bi[p0:p1], cl, output_size=tot)
            pos = (torch.arange(e0, e0 + tot, device=q.device)
                   + torch.repeat_interleave(shift[p0:p1], cl,
                                             output_size=tot))
            d2 = tile_sum_sq(q[probe] - self._pts[pos], fma=False)
            hit = d2 <= float(self._eps2)
            cnt.scatter_add_(0, probe, hit.long())
            mn.scatter_reduce_(0, probe, torch.where(
                hit, self._vals[pos], INT_MAX), "amin")
            p0 = p1
        return cnt, mn

    @classmethod
    def _note_syncs(cls, n: int) -> None:
        with cls._syncs_lock:
            cls.host_syncs += n


def freeze(handle, *, version: int = 0) -> IndexSnapshot:
    """Freeze a live :class:`repro_torch.stream.StreamingDBSCAN` handle
    into an immutable :class:`IndexSnapshot` at its (eps, min_pts), on the
    handle's device.

    Each publish copies and sorts the tenant's whole active set; the
    ``serve.freeze`` span times it (``chip_smoke.py [serve]
    publish_ms``)."""
    with obs_trace.span("serve.freeze", version=version):
        state = handle.freeze_view()
        snap = IndexSnapshot.build(state, handle.eps, handle.min_pts,
                                   version=version)
    return snap


class SnapshotStore:
    """The published-snapshot cell: one atomic reference, swapped whole.

    Readers call :meth:`current` — a single attribute load, never a lock
    — and use the returned snapshot for as long as they like; it is
    immutable, so a concurrent publish can't corrupt an in-flight batch.
    Writers build the next snapshot *off-path* and :meth:`publish` it;
    the ``mid-publish`` durability barrier sits between build and swap so
    the fault harness can prove a crash there leaves the old version
    serving after recovery. ``keep`` > 1 retains a short version history
    (``get``) for the linearizability tests.

    On the card a reader keeps its snapshot until the results of its query
    have been copied to the host (``query`` returns host arrays, so that
    holds for every caller of it). Only then may an evicted snapshot's
    memory, allocated on the writer's stream, go back to the caching
    allocator and be reused by the writer while the reader's stream still
    had kernels reading it.
    """

    def __init__(self, snapshot: IndexSnapshot | None = None, *,
                 keep: int = 1):
        self._lock = threading.Lock()
        self._keep = max(1, int(keep))
        self._history: dict[int, IndexSnapshot] = {}
        self._current: IndexSnapshot | None = None
        if snapshot is not None:
            self.publish(snapshot)

    def current(self) -> IndexSnapshot | None:
        """The currently published snapshot (lock-free read)."""
        return self._current

    def get(self, version: int) -> IndexSnapshot | None:
        """A retained historical version (None once evicted)."""
        with self._lock:
            return self._history.get(version)

    @property
    def version(self) -> int:
        """Version of the current snapshot; -1 before the first publish."""
        snap = self._current
        return snap.version if snap is not None else -1

    def publish(self, snapshot: IndexSnapshot) -> IndexSnapshot:
        """Atomically swap ``snapshot`` in as the serving version.

        Versions must be monotonic — a stale writer (e.g. a recovered
        process racing an old one) cannot roll the serving view back.
        """
        cur = self._current
        if cur is not None and snapshot.version <= cur.version:
            raise ValueError(
                f"snapshot versions must be monotonic: have v{cur.version}, "
                f"got v{snapshot.version}")
        durability.barrier("mid-publish")   # crash here: the old (fully
        with self._lock:                    # durable) version keeps serving
            self._current = snapshot
            self._history[snapshot.version] = snapshot
            while len(self._history) > self._keep:
                del self._history[min(self._history)]
        # metrics: TenantView.publish owns the serve_snapshot_* series —
        # it knows the tenant label; a bare store stays silent
        return snapshot
