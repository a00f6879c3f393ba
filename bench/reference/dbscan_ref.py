"""Plain reference for DBSCAN: the checker that decides ``correct``, and a
solver for the control.

Plain PyTorch on whatever device the points are on. It imports nothing of
the program under test and takes nothing it made: the points come from the
benchmark's own generator, and the program's labels and core mask are read
only to be judged.

*Within eps.* A pair is within eps when its float32 squared distance is at
most ``float32(eps) ** 2`` (rounded in float32). The squared distance of
``diff = q - p`` (float32) is rounded in one of these ways:

* ``fma``: ``diff0 * diff0``, then one fused multiply-add per further axis
  (the rounding the configurations state, that of the reference package's
  compiled code);
* ``unfused``: every product and sum rounded on its own, in axis order;
* ``tf32``: each ``diff`` rounded to TF32 first (10 mantissa bits), then
  summed in float32: what a TF32 dot product gives. Only the control uses
  it.

A check takes a *strict* and a *loose* set of roundings: a pair is surely
within eps when every strict rounding says so, and may be within eps when
any loose rounding does. With one rounding both sets are that rounding and
the check is exact. A path that decides some pairs in one rounding and some
in another (the streaming index counts new batches unfused) is checked
with ``fma`` and ``unfused`` in both sets, which differ only on pairs within
an ulp of eps.

*How it scales.* Two grids bin the points: cells of side ``1.01 eps``
(any pair within eps lies in neighbouring cells) to enumerate candidate
pairs, and cells of side ``eps / sqrt(d) * (1 - 2**-10)`` (any two points
in one are within eps in every rounding) to shortcut dense cells. Core
points in one small cell form one node of the connectivity graph; an edge
joins two nodes when some pair of their core points is within eps, found
first on a sample of pairs and then, for nodes still in different
components, on all of them.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

# Candidate pairs expanded at once (the memory of one block is about 60
# bytes a pair).
BLOCK = 1 << 24
# Points of each node tested against each other in the sampled rounds.
SAMPLE = 8
SAMPLE_ROUNDS = 3
INF = torch.iinfo(torch.int64).max


# --------------------------------------------------------------------- #
# float32 arithmetic                                                     #
# --------------------------------------------------------------------- #

def radius2(eps: float) -> float:
    """``eps`` rounded to float32 and squared in float32."""
    e = np.float32(eps)
    return float(e * e)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding to float32 (float32 inputs).

    The product is exact in float64. The float64 sum is rounded to odd
    (its last bit set when the sum was inexact, from the exact error of
    the addition), and rounding a round-to-odd float64 to float32 gives the
    correctly rounded float32 result."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)
    bits = torch.where(inexact_even, torch.where(away, bits + 1, bits - 1),
                       bits)
    return bits.view(torch.float64).float()


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 explicit mantissa bits, nearest,
    ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def dist2(diff: torch.Tensor, rounding: str) -> torch.Tensor:
    """Squared norms of the rows of ``diff`` (float32) in ``rounding``."""
    d = diff.shape[-1]
    if rounding == "tf32":
        diff = to_tf32(diff)
    out = diff[..., 0] * diff[..., 0]
    for k in range(1, d):
        x = diff[..., k]
        out = fma32(x, x, out) if rounding == "fma" else out + x * x
    return out


class Rounding(NamedTuple):
    """The roundings a pair test is held to (see the module docstring)."""
    strict: tuple
    loose: tuple

    @classmethod
    def of(cls, spec) -> "Rounding":
        names = (spec,) if isinstance(spec, str) else tuple(spec)
        for r in names:
            if r not in ("fma", "unfused", "tf32"):
                raise ValueError(f"unknown rounding {r!r}")
        return cls(names, names)

    @property
    def exact(self) -> bool:
        return len(set(self.strict) | set(self.loose)) == 1

    def within(self, diff: torch.Tensor, eps2: float):
        """(surely within, maybe within) for each row of ``diff``."""
        got = {r: dist2(diff, r) <= eps2
               for r in set(self.strict) | set(self.loose)}
        strict = got[self.strict[0]]
        for r in self.strict[1:]:
            strict = strict & got[r]
        loose = got[self.loose[0]]
        for r in self.loose[1:]:
            loose = loose | got[r]
        return strict, loose


# --------------------------------------------------------------------- #
# grids and candidate pairs                                              #
# --------------------------------------------------------------------- #

class Grid:
    """Points binned into cubic cells of side ``side``, sorted by cell.

    ``order[k]`` is the caller's index of the k-th point in cell order;
    cell ``c`` holds sorted positions ``[start[c], start[c] + count[c])``.
    A margin of ``reach`` empty cells on every side keeps neighbour keys
    from wrapping into other rows of the key space."""

    def __init__(self, pts: torch.Tensor, side: float, reach: int):
        x = pts.double()
        self.d = pts.shape[1]
        lo = x.min(0).values
        coords = torch.floor((x - lo) / side).long() + reach
        dims = coords.max(0).values + reach + 1
        strides = [1] * self.d
        for k in range(self.d - 2, -1, -1):
            strides[k] = strides[k + 1] * int(dims[k + 1])
        if strides[0] * int(dims[0]) >= 2 ** 62:
            raise ValueError("grid too fine for 64-bit cell keys")
        self.strides = torch.tensor(strides, dtype=torch.int64,
                                    device=pts.device)
        key = (coords * self.strides).sum(1)
        self.order = torch.argsort(key, stable=True)
        skey = key[self.order]
        self.keys, self.count = torch.unique_consecutive(
            skey, return_counts=True)
        self.start = torch.cumsum(self.count, 0) - self.count
        self.cell = torch.repeat_interleave(
            torch.arange(self.keys.numel(), device=pts.device), self.count)

    def offsets(self, reach: int) -> list:
        return list(itertools.product(range(-reach, reach + 1),
                                      repeat=self.d))

    def lookup(self, cells: torch.Tensor, offset) -> torch.Tensor:
        """Cell index of ``cells`` shifted by ``offset``, -1 where empty."""
        shift = int((torch.tensor(offset, dtype=torch.int64,
                                  device=self.keys.device)
                     * self.strides).sum())
        nkey = self.keys[cells] + shift
        pos = torch.searchsorted(self.keys, nkey).clamp_max(
            self.keys.numel() - 1)
        return torch.where(self.keys[pos] == nkey, pos, -1)


def _ranges_around(grid: Grid, cells: torch.Tensor, owners: torch.Tensor,
                   reach: int = 1):
    """For each (owner, neighbouring cell of its cell): the owner and the
    cell's sorted range ``[start, start + length)``, empty cells dropped."""
    own, st, ln = [], [], []
    for off in grid.offsets(reach):
        nb = grid.lookup(cells, off)
        ok = nb >= 0
        own.append(owners[ok])
        st.append(grid.start[nb[ok]])
        ln.append(grid.count[nb[ok]])
    return torch.cat(own), torch.cat(st), torch.cat(ln)


def expand_pairs(owner: torch.Tensor, start: torch.Tensor,
                 length: torch.Tensor, block: int = BLOCK):
    """Yield ``(owner, j)`` tensors for every ``j`` in every range, in
    blocks of about ``block`` pairs (a range is never split)."""
    if owner.numel() == 0:
        return
    csum = torch.cumsum(length, 0)
    total = int(csum[-1])
    marks = torch.arange(block, max(total, block), block,
                         device=owner.device)
    cuts = [0] + torch.searchsorted(csum, marks, right=True).tolist() \
        + [owner.numel()]
    for e0, e1 in zip(cuts[:-1], cuts[1:]):
        if e1 <= e0:
            continue
        ln = length[e0:e1]
        tot = int(ln.sum())
        if tot == 0:
            continue
        rep = torch.repeat_interleave(torch.arange(e0, e1,
                                                   device=owner.device), ln,
                                      output_size=tot)
        first = torch.cumsum(ln, 0) - ln
        j = start[rep] + (torch.arange(tot, device=owner.device)
                          - first[rep - e0])
        yield owner[rep], j


# --------------------------------------------------------------------- #
# counts, components, labels                                             #
# --------------------------------------------------------------------- #

class Reference(NamedTuple):
    """What the reference worked out for one point set (caller's order)."""
    core_strict: torch.Tensor    # bool: surely core
    core_loose: torch.Tensor     # bool: maybe core
    count_strict: torch.Tensor   # int64, saturated at min_pts (dense: min_pts)
    dense: torch.Tensor          # bool: in a small cell of >= min_pts points


def core_counts(pts: torch.Tensor, eps: float, min_pts: int,
                rounding: Rounding, block: int = BLOCK) -> Reference:
    """Neighbour counts (the point itself included) saturated at
    ``min_pts``, and the core masks they give."""
    n, d = pts.shape
    dev = pts.device
    eps2 = radius2(eps)
    small = Grid(pts, eps / math.sqrt(d) * (1 - 2 ** -10), 2)
    dense = torch.zeros(n, dtype=torch.bool, device=dev)
    dense[small.order] = small.count[small.cell] >= min_pts
    big = Grid(pts, eps * 1.01, 1)
    spts = pts[big.order]
    sdense = dense[big.order]
    q = torch.nonzero(~sdense).flatten()
    cs = torch.zeros(n, dtype=torch.int64, device=dev)
    cl = torch.zeros(n, dtype=torch.int64, device=dev)
    own, st, ln = _ranges_around(big, big.cell[q], q)
    for qi, j in expand_pairs(own, st, ln, block):
        s, l = rounding.within(spts[qi] - spts[j], eps2)
        cs.index_add_(0, qi, s.long())
        cl.index_add_(0, qi, l.long())
    cs = torch.where(sdense, min_pts, cs.clamp_max(min_pts))
    cl = torch.where(sdense, min_pts, cl.clamp_max(min_pts))
    inv = torch.empty_like(big.order)
    inv[big.order] = torch.arange(n, device=dev)
    cs, cl = cs[inv], cl[inv]
    return Reference(core_strict=cs >= min_pts, core_loose=cl >= min_pts,
                     count_strict=cs, dense=dense)


def _find(parent: torch.Tensor) -> torch.Tensor:
    """``parent`` with every entry pointing at its root."""
    while True:
        nxt = parent[parent]
        if torch.equal(nxt, parent):
            return parent
        parent = nxt


def _union(parent: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """Merge the components of each pair ``(a[i], b[i])``; roots point at
    the smaller root."""
    parent = _find(parent)
    while a.numel():
        ra, rb = parent[a], parent[b]
        diff = ra != rb
        if not bool(diff.any()):
            break
        a, b, ra, rb = a[diff], b[diff], ra[diff], rb[diff]
        parent = parent.scatter_reduce(0, torch.maximum(ra, rb),
                                       torch.minimum(ra, rb), "amin")
        parent = _find(parent)
    return parent


def components(pts: torch.Tensor, core: torch.Tensor, eps: float,
               roundings, block: int = BLOCK) -> list:
    """Connected components of the core points under each rounding set in
    ``roundings`` (a list of tuples of rounding names; a pair is an edge
    when every rounding of the tuple puts it within eps). Returns one
    (n,) int64 tensor per set: the component's smallest point index for a
    core point, -1 elsewhere."""
    n, d = pts.shape
    dev = pts.device
    eps2 = radius2(eps)
    cidx = torch.nonzero(core).flatten()
    out = []
    if cidx.numel() == 0:
        return [torch.full((n,), -1, dtype=torch.int64, device=dev)
                for _ in roundings]
    cp = pts[cidx]
    small = Grid(cp, eps / math.sqrt(d) * (1 - 2 ** -10), 2)
    spts = cp[small.order]
    m = small.keys.numel()
    # candidate node pairs: each unordered pair of nodes within reach once
    na, nb = [], []
    allc = torch.arange(m, device=dev)
    for off in small.offsets(2):
        if off <= tuple([0] * d):
            continue
        nbc = small.lookup(allc, off)
        ok = nbc >= 0
        na.append(allc[ok])
        nb.append(nbc[ok])
    na, nb = torch.cat(na), torch.cat(nb)
    for names in roundings:
        rnd = Rounding(tuple(names), tuple(names))
        parent = torch.arange(m, device=dev)
        for r in range(SAMPLE_ROUNDS):
            parent = _find(parent)
            act = parent[na] != parent[nb]
            a, b = na[act], nb[act]
            if a.numel() == 0:
                break
            k = torch.arange(SAMPLE, device=dev)
            ia = (small.start[a, None] + (k * (r + 1) + r)
                  % small.count[a, None])
            ib = (small.start[b, None] + (k * (r + 2) + 2 * r)
                  % small.count[b, None])
            # every sample of a against every sample of b, in chunks
            found = torch.zeros(a.numel(), dtype=torch.bool, device=dev)
            step = max(1, block // (SAMPLE * SAMPLE))
            for lo in range(0, a.numel(), step):
                pa = spts[ia[lo:lo + step]]          # (c, S, d)
                pb = spts[ib[lo:lo + step]]
                diff = pa[:, :, None, :] - pb[:, None, :, :]
                s, _ = rnd.within(diff, eps2)
                found[lo:lo + step] = s.flatten(1).any(1)
            parent = _union(parent, a[found], b[found])
        tested = torch.zeros(na.numel(), dtype=torch.bool, device=dev)
        while True:
            parent = _find(parent)
            act = torch.nonzero((parent[na] != parent[nb])
                                & ~tested).flatten()
            if act.numel() == 0:
                break
            tested[act] = True
            a, b = na[act], nb[act]
            # all pairs: for each member of a, the range of b
            la = small.count[a]
            own = torch.repeat_interleave(torch.arange(act.numel(),
                                                       device=dev), la)
            first = torch.cumsum(la, 0) - la
            mem = small.start[a][own] + (torch.arange(own.numel(),
                                                      device=dev)
                                         - first[own])
            hit = torch.zeros(act.numel(), dtype=torch.bool, device=dev)
            for pi, j in expand_pairs(torch.arange(own.numel(), device=dev),
                                      small.start[b][own], small.count[b][own],
                                      block):
                s, _ = rnd.within(spts[mem[pi]] - spts[j], eps2)
                hit.index_fill_(0, own[pi[s]], True)
            parent = _union(parent, a[hit], b[hit])
        root = _find(parent)[small.cell]          # per sorted core point
        # component id: the smallest caller index among its points
        orig = cidx[small.order]
        low = torch.full((m,), INF, dtype=torch.int64, device=dev)
        low = low.scatter_reduce(0, root, orig, "amin")
        comp = torch.full((n,), -1, dtype=torch.int64, device=dev)
        comp[orig] = low[root]
        out.append(comp)
    return out


def neighbours_of(queries: torch.Tensor, pts: torch.Tensor, eps: float,
                  rounding: Rounding, block: int = BLOCK):
    """Yield ``(qi, j, strict, loose)`` for the candidate pairs of query
    rows ``queries`` against point rows ``pts`` (indices into each)."""
    if queries.shape[0] == 0 or pts.shape[0] == 0:
        return
    eps2 = radius2(eps)
    grid = Grid(torch.cat([pts, queries]), eps * 1.01, 1)
    n = pts.shape[0]
    pos = torch.empty_like(grid.order)
    pos[grid.order] = torch.arange(grid.order.numel(), device=pts.device)
    is_pt = grid.order < n
    # ranges over points only: points and queries share cells, so count
    # points per cell and sort points first within each cell
    key2 = grid.cell * 2 + (~is_pt).long()
    o2 = torch.argsort(key2, stable=True)
    order = grid.order[o2]                    # points first in each cell
    npts = torch.zeros(grid.keys.numel(), dtype=torch.int64,
                       device=pts.device)
    npts.index_add_(0, grid.cell, is_pt.long())
    qrow = torch.arange(queries.shape[0], device=pts.device)
    qcell = grid.cell[pos[n + qrow]]
    own, st, ln = [], [], []
    for off in grid.offsets(1):
        nb = grid.lookup(qcell, off)
        ok = nb >= 0
        own.append(qrow[ok])
        st.append(grid.start[nb[ok]])
        ln.append(npts[nb[ok]])
    own, st, ln = torch.cat(own), torch.cat(st), torch.cat(ln)
    keep = ln > 0
    for qi, jj in expand_pairs(own[keep], st[keep], ln[keep], block):
        j = order[jj]
        s, l = rounding.within(queries[qi] - pts[j], eps2)
        yield qi, j, s, l


# --------------------------------------------------------------------- #
# judging a clustering                                                   #
# --------------------------------------------------------------------- #

def check_clustering(pts: torch.Tensor, eps: float, min_pts: int,
                     labels: torch.Tensor, core: torch.Tensor,
                     n_clusters: int, rounding="fma",
                     block: int = BLOCK) -> dict:
    """Hold a clustering (``labels``: -1 noise, else a cluster id;
    ``core``: the core mask; both in the order of ``pts``) to DBSCAN's
    definition. Returns the number of violations of each kind (all 0 for a
    correct clustering) and the reference's own readings."""
    rnd = rounding if isinstance(rounding, Rounding) else Rounding.of(rounding)
    n = pts.shape[0]
    dev = pts.device
    labels = labels.to(dev).long()
    core = core.to(dev).bool()
    ref = core_counts(pts, eps, min_pts, rnd, block)
    core_bad = (ref.core_strict & ~core) | (core & ~ref.core_loose)
    out = {"core_mismatch": int(core_bad.sum())}
    # partition of the core points: the components of the surely-within
    # graph each lie inside one label, and each label lies inside one
    # component of the maybe-within graph
    C = core if out["core_mismatch"] == 0 else ref.core_strict
    sets = [rnd.strict] if rnd.exact else [rnd.strict, rnd.loose]
    comps = components(pts, C, eps, sets, block)
    strict_c, loose_c = comps[0], comps[-1]
    lab = labels[C]
    out["core_unlabeled"] = int((lab < 0).sum())
    out["clusters_split"] = _one_to_many(strict_c[C], lab)
    out["clusters_merged"] = _one_to_many(lab, loose_c[C])
    distinct = torch.unique(lab[lab >= 0])
    out["label_errors"] = int(
        (distinct.numel() != n_clusters)
        + int(((labels >= n_clusters) | (labels < -1)).sum()))
    # border points: labelled iff a core point is within eps, and with the
    # label of one such core point
    nc = torch.nonzero(~C).flatten()
    cidx = torch.nonzero(C).flatten()
    must = torch.zeros(nc.numel(), dtype=torch.bool, device=dev)
    match = torch.zeros(nc.numel(), dtype=torch.bool, device=dev)
    lab_nc = labels[nc]
    for qi, j, s, l in neighbours_of(pts[nc], pts[cidx], eps, rnd, block):
        must.index_fill_(0, qi[s], True)
        ok = l & (labels[cidx[j]] == lab_nc[qi])
        match.index_fill_(0, qi[ok], True)
    border_bad = ((lab_nc < 0) & must) | ((lab_nc >= 0) & ~match)
    out["border_errors"] = int(border_bad.sum())
    out["_ref"] = {"core": int(ref.core_strict.sum()),
                   "clusters": int(torch.unique(strict_c[C]).numel())
                   if C.any() else 0}
    out["_state"] = (ref, C, comps)
    return out


def _one_to_many(a: torch.Tensor, b: torch.Tensor) -> int:
    """How many values of ``a`` pair with more than one value of ``b``."""
    if a.numel() == 0:
        return 0
    pairs = torch.unique(torch.stack([a, b], 1), dim=0)
    _, per = torch.unique_consecutive(pairs[:, 0], return_counts=True)
    return int((per > 1).sum())


def solve(pts: torch.Tensor, eps: float, min_pts: int, rounding="fma",
          block: int = BLOCK):
    """DBSCAN by the reference itself: ``(labels, core, n_clusters)``,
    labels numbered by each cluster's smallest point index, a border point
    given the smallest label among its core neighbours. The control puts
    this, in a lower precision, in the program's place."""
    rnd = rounding if isinstance(rounding, Rounding) else Rounding.of(rounding)
    n = pts.shape[0]
    dev = pts.device
    ref = core_counts(pts, eps, min_pts, rnd, block)
    core = ref.core_strict
    comp = components(pts, core, eps, [rnd.strict], block)[0]
    uniq = torch.unique(comp[core])
    labels = torch.full((n,), -1, dtype=torch.int64, device=dev)
    labels[core] = torch.searchsorted(uniq, comp[core])
    nc = torch.nonzero(~core).flatten()
    cidx = torch.nonzero(core).flatten()
    best = torch.full((nc.numel(),), INF, dtype=torch.int64, device=dev)
    for qi, j, s, _ in neighbours_of(pts[nc], pts[cidx], eps, rnd, block):
        best = best.scatter_reduce(0, qi[s], labels[cidx[j[s]]], "amin")
    labels[nc] = torch.where(best == INF, -1, best)
    return labels.to(torch.int32), core, int(uniq.numel())
