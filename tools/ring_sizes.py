"""Time the dense ring (``repro_torch.distributed.ring_dbscan.ring_dbscan``)
on the card at several sizes and densities, on 8 shards of a local mesh,
and hold each result against single-device fdbscan (core mask and core
partition): how ``chip_smoke.py``'s ``[ring]`` size was chosen.

    python3 tools/ring_sizes.py               # integer-lattice points
    python3 tools/ring_sizes.py --separated   # separated uniform points

Lattice points (``chip_smoke.lattice``) have exact squared distances in
both arithmetic forms. ``--separated`` draws uniform points with no pair
within 0.2% of eps^2 of the boundary (candidate pairs from a k-d tree,
scipy), where the tiles' norm form may still round a pair across a small
eps^2. Each line: n, eps, min_pts, seconds (host clock around a
synchronised call), sweeps, clusters, and whether fdbscan agrees. Stops
after the first run over 30 s.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
import repro_torch  # noqa: E402
from repro_torch.distributed import ring_dbscan as rd, sharding  # noqa: E402

# (n, lattice side, eps, min_pts)
LATTICE = [(262_144, 2048, 4.5, 5), (262_144, 2048, 5.5, 5),
           (393_216, 2048, 4.5, 5), (524_288, 2048, 3.5, 5),
           (524_288, 2048, 3.2, 4)]
# (n, eps, min_pts): about six neighbours a point
SEPARATED = [(262_144, 0.0027, 5)]


def separated(n: int, d: int, eps: float, seed: int) -> np.ndarray:
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    e2 = eps * eps
    while True:
        x = pts.astype(np.float64)
        pairs = cKDTree(x).query_pairs(eps * 1.002, output_type="ndarray")
        d2 = ((x[pairs[:, 0]] - x[pairs[:, 1]]) ** 2).sum(-1)
        rows = np.unique(pairs[np.abs(d2 - e2) < 2e-3 * e2, 0])
        if len(rows) == 0:
            return pts
        pts[rows] = rng.uniform(0, 1, size=(len(rows), d)).astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--separated", action="store_true")
    args = ap.parse_args()
    cs.phase_environment()
    if args.separated:
        runs = [(separated(n, 2, eps, seed=23), eps, mp)
                for n, eps, mp in SEPARATED]
    else:
        runs = [(cs.lattice(n, 2, g, seed=23), eps, mp)
                for n, g, eps, mp in LATTICE]
    for pts, eps, mp in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rd.ring_dbscan(pts, eps, mp, mesh=sharding.LocalMesh(8))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ref = repro_torch.dbscan(pts, eps, mp, algorithm="fdbscan")
        cs.say("ring-size", n=len(pts), eps=eps, min_pts=mp,
               seconds=f"{seconds:.2f}", n_sweeps=res.n_sweeps,
               n_clusters=res.n_clusters,
               same_as_fdbscan=cs.same_core_partition(res, ref))
        if seconds > 30:
            break


if __name__ == "__main__":
    main()
