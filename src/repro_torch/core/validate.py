"""DBSCAN-axiom checker: validates a labeling against first principles.

Border points may legitimately belong to any adjacent cluster (the paper
assigns "first encountered", we assign min-representative), so label arrays
cannot be compared naively. This checker accepts exactly the set of valid
DBSCAN labelings:

  A1  core_mask is correct: |N_eps(x)| >= minpts  <=>  core.
  A2  density-connected core points share a label (same component of the
      core-core eps-graph).
  A3  core points in different components have different labels.
  A4  a border point (non-core with >= 1 core neighbor) carries the label of
      at least one core neighbor.
  A5  noise (non-core, no core neighbor) is labeled -1; nothing else is.

All adjacency questions are answered from *blocked* row tiles (~2k rows at
a time) so the checker never materializes the n x n float64 distance
matrix — conformance runs at n >= 50k stay within O(n * block) memory.
Component structure is recovered with vectorized min-label relaxation +
pointer jumping over the same tiles, re-deriving adjacency per pass instead
of storing it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs import syncs


def check_points(points, *, name: str = "points", allow_empty: bool = False,
                 dims: tuple = None, d: int = None) -> np.ndarray:
    """Validate a user-supplied point batch at the public surface.

    One shared gate for every entry point (``dispatch.plan``/``dbscan``): a
    malformed batch must raise a clear ``ValueError`` *here*, not produce
    garbage Morton codes and silently wrong labels three layers down.

    Rejects: non-numeric / bool / complex dtypes, non-2-d shapes, empty
    point sets (unless ``allow_empty``), NaN/Inf coordinates, and a
    dimensionality outside ``dims`` (or different from ``d``).

    Args:
        points: any array-like the caller intends as an (n, d) batch.
        name: how to call the argument in error messages.
        allow_empty: permit n == 0 (e.g. an optional initial set).
        dims: allowed dimensionalities, e.g. ``(2, 3)``; None = any.
        d: exact required dimensionality (e.g. an index's own d).

    Returns:
        The batch as a host ``np.ndarray`` (no copy when the input
        already is one; a torch tensor is copied to the host); callers do
        their own dtype conversion.

    Raises:
        ValueError: any of the rejections above, with the offending
            rows named for the NaN/Inf case.
    """
    if isinstance(points, torch.Tensor):
        points = syncs.read(points.detach(), "validate.points")
    try:
        arr = np.asarray(points)
    except (ValueError, TypeError) as e:
        raise ValueError(f"{name} is not a numeric array: {e}")
    if (arr.dtype == object or arr.dtype.kind not in "iuf"):
        raise ValueError(
            f"{name} must be a real-valued numeric array; got dtype "
            f"{arr.dtype} (bool/complex/object inputs would be cast to "
            "garbage coordinates silently)")
    if arr.ndim != 2:
        raise ValueError(f"{name} must have shape (n, d); got {arr.shape}")
    if arr.shape[0] == 0 and not allow_empty:
        raise ValueError(f"{name} is empty: got shape {arr.shape} "
                         "(an empty point set has no clustering)")
    if d is not None and arr.shape[1] != d:
        raise ValueError(f"{name} must be {d}-dimensional to match the "
                         f"index; got {arr.shape[1]}-d")
    if dims is not None and arr.shape[1] not in dims:
        raise ValueError(f"{name} must have d in {dims}; got shape "
                         f"{arr.shape}")
    if arr.dtype.kind == "f" and arr.size and not np.isfinite(arr).all():
        bad = np.flatnonzero(~np.isfinite(arr).all(axis=1))
        raise ValueError(
            f"{name} contains {len(bad)} row(s) with non-finite (NaN/Inf) "
            f"coordinates, first at rows {bad[:5].tolist()} — these would "
            "corrupt the Morton codes, not cluster as outliers")
    return arr

# Row-tile height for all blocked adjacency passes: n * block boolean cells
# live at once (~2k * n bits), never the n^2 matrix.
ORACLE_BLOCK = 2048


def adjacency_blocks(points, eps: float, block: int = ORACLE_BLOCK):
    """Yield ``(lo, hi, adj)`` row tiles of the eps-adjacency matrix.

    ``adj`` is the boolean slice ``[lo:hi, :]``, float64, via the BLAS
    Gram form ``|a|^2 + |b|^2 - 2ab`` (a dgemm per tile — the blocked
    oracle stays usable at n >= 50k). On the integer-grid property data
    every term is an exact float64 integer, so boundary decisions are
    exact; float data in the test-suite keeps a separation band around eps
    many orders above the ~1e-16 relative rounding of this form. Shared by
    :func:`check_dbscan` and :func:`neighbor_counts`.
    """
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    e2 = eps * eps
    sq = (pts * pts).sum(-1)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        d2 = sq[lo:hi, None] + sq[None, :] - 2.0 * (pts[lo:hi] @ pts.T)
        yield lo, hi, d2 <= e2


def neighbor_counts(points, eps: float, block: int = ORACLE_BLOCK
                    ) -> np.ndarray:
    """|N_eps(x)| per point (self included), blocked."""
    pts = np.asarray(points, np.float64)
    counts = np.zeros(pts.shape[0], np.int64)
    for lo, hi, adj in adjacency_blocks(pts, eps, block):
        counts[lo:hi] = adj.sum(1)
    return counts


# Core-core edge budget for the one-pass component path (~1.6 GB as two
# int64 arrays); denser graphs fall back to per-pass tile re-derivation.
_EDGE_CAP = 100_000_000


def _jump(comp: np.ndarray) -> np.ndarray:
    """Pointer-jump ``comp`` (an index-valued forest, comp[i] <= i) to its
    fixpoint."""
    while True:
        jumped = comp[comp]
        if (jumped == comp).all():
            return comp
        comp = jumped


def _core_components(pts, eps, core, block) -> np.ndarray:
    """Min-index representative of each core point's core-core component.

    One blocked tile pass extracts the core-core edge list; vectorized
    min-label relaxation (``np.minimum.at``) + pointer jumping then runs to
    a fixpoint over it — the NumPy analogue of the library's hook + jump
    loop, kept independent of the code under test. If the graph exceeds
    ``_EDGE_CAP`` edges, relaxation re-derives adjacency from tiles per
    pass instead (slower, still O(n * block) memory).
    """
    n = pts.shape[0]
    comp = np.arange(n)
    srcs, dsts, total = [], [], 0
    for lo, hi, adj in adjacency_blocks(pts, eps, block):
        sub = adj & core[None, :] & core[lo:hi, None]
        r, c = np.nonzero(sub)
        total += len(r)
        if total > _EDGE_CAP:
            srcs = None
            break
        srcs.append((r + lo).astype(np.int64))
        dsts.append(c.astype(np.int64))

    if srcs is not None:
        src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
        dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
        while True:
            new = comp.copy()
            np.minimum.at(new, src, comp[dst])
            new = _jump(new)
            if (new == comp).all():
                return comp
            comp = new

    while True:  # over-budget fallback: re-derive adjacency per pass
        new = comp.copy()
        for lo, hi, adj in adjacency_blocks(pts, eps, block):
            sub = adj & core[None, :]
            gathered = np.where(sub, comp[None, :], n).min(1)
            new[lo:hi] = np.where(core[lo:hi],
                                  np.minimum(new[lo:hi], gathered),
                                  new[lo:hi])
        new = _jump(new)
        if (new == comp).all():
            return comp
        comp = new


def check_dbscan(points, eps: float, min_pts: int, labels, core_mask,
                 block: int = ORACLE_BLOCK) -> None:
    pts = np.asarray(points, np.float64)
    labels = np.asarray(labels)
    core = np.asarray(core_mask)
    n = pts.shape[0]

    counts = neighbor_counts(pts, eps, block)
    ref_core = counts >= min_pts
    assert (core == ref_core).all(), (
        f"A1 core mask mismatch at {np.nonzero(core != ref_core)[0][:10]}")

    comp = _core_components(pts, eps, ref_core, block)

    ci = np.nonzero(ref_core)[0]
    for i in ci:
        assert labels[i] >= 0, f"A2 core point {i} labeled noise"
    # A2/A3: label partition == component partition on core points
    for rep in np.unique(comp[ref_core]):
        ls = np.unique(labels[ref_core & (comp == rep)])
        assert len(ls) == 1, f"A2 component {rep} split into labels {ls}"
    by_label = {}
    for i in ci:
        by_label.setdefault(int(labels[i]), set()).add(int(comp[i]))
    for l, comps in by_label.items():
        assert len(comps) == 1, f"A3 label {l} merges components {comps}"

    # A4/A5 witnesses per non-core point, gathered from the same row tiles
    has_core_nbr = np.zeros(n, bool)
    label_ok = np.zeros(n, bool)   # some core neighbor carries labels[i]
    for lo, hi, adj in adjacency_blocks(pts, eps, block):
        sub = adj & ref_core[None, :]
        has_core_nbr[lo:hi] = sub.any(1)
        label_ok[lo:hi] = (sub & (labels[None, :]
                                  == labels[lo:hi, None])).any(1)
    for i in np.nonzero(~ref_core)[0]:
        if not has_core_nbr[i]:
            assert labels[i] == -1, f"A5 isolated point {i} not noise"
        else:
            assert label_ok[i], (
                f"A4 border {i} labeled {labels[i]} but no core neighbor "
                f"carries that label")


def check_component_identical(labels_a, core_a, labels_b, core_b) -> None:
    """Assert two DBSCAN results are *component-identical*: exact core
    mask, exact noise set, identical partition of the core points.

    This is the strongest comparison that is well-defined across backends
    — border points may legitimately attach to any adjacent cluster (see
    the module docstring), so full label arrays are never compared
    elementwise. The streaming subsystem's snapshot()-vs-batch contract
    (DESIGN.md §7) is stated in exactly these terms; the benchmark, the
    serving loop's ``--validate``, and the test suite all share this one
    definition.
    """
    ca, cb = np.asarray(core_a), np.asarray(core_b)
    assert (ca == cb).all(), "core mask differs"
    la, lb = np.asarray(labels_a), np.asarray(labels_b)
    assert ((la == -1) == (lb == -1)).all(), "noise set differs"
    assert same_partition(la[ca], lb[ca]), "core partition differs"


def same_partition(labels_a, labels_b) -> bool:
    """True iff two labelings induce the same partition (noise == noise)."""
    a = np.asarray(labels_a)
    b = np.asarray(labels_b)
    if ((a == -1) != (b == -1)).any():
        return False
    fwd, bwd = {}, {}
    for x, y in zip(a, b):
        if x == -1:
            continue
        if fwd.setdefault(int(x), int(y)) != y:
            return False
        if bwd.setdefault(int(y), int(x)) != x:
            return False
    return True
