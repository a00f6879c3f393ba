"""Quickstart: the stable top-level ``repro_torch`` surface (the PyTorch/CUDA
port's counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py        # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu -n 600

(``--device cpu`` runs the plain versions of the kernels on the host.)

Everything here goes through the package root's exports
(``repro_torch.dbscan``, ``repro_torch.plan``, ``repro_torch.stream_handle``,
``repro_torch.neighbors``, ``repro_torch.DBSCANResult``), plus a mesh from
``repro_torch.launch.mesh`` for the sharded path. The checks use the port's
own validators and brute-force oracle; nothing of the JAX package is
imported.
"""
import argparse

import numpy as np

import repro_torch
from repro_torch.core import dbscan_bruteforce_np
from repro_torch.core.validate import (check_component_identical,
                                       check_dbscan, same_partition)
from repro_torch.data import pointclouds
from repro_torch.launch.mesh import make_local_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' runs the "
                    "plain PyTorch versions of the kernels")
    ap.add_argument("-n", type=int, default=2000, help="points (>= 8)")
    args = ap.parse_args(argv)
    dev, n = args.device, args.n
    pts = pointclouds.blobs(n, k=6, seed=42)
    eps, min_pts = 0.04, 8

    for algo in ("fdbscan", "fdbscan-densebox", "tiled", "pallas-tree"):
        res = repro_torch.dbscan(pts, eps, min_pts, algorithm=algo,
                                 device=dev)
        assert isinstance(res, repro_torch.DBSCANResult)
        labels = res.labels.cpu().numpy()
        print(f"{algo:18s}: {res.n_clusters} clusters, "
              f"{int((labels == -1).sum())} noise pts, "
              f"{res.n_sweeps} union-find sweeps")
        # validate against the DBSCAN axioms (oracle-backed)
        check_dbscan(pts, eps, min_pts, labels, res.core_mask.cpu().numpy())

    # parameter sweeps reuse one cached eps-independent index via plan()
    p = repro_torch.plan(pts, eps, min_pts, algorithm="fdbscan", device=dev)
    res = repro_torch.dbscan(pts, eps, min_pts, query_plan=p)
    print(f"{'planned (cached)':18s}: backend={res.backend}")

    # brute-force oracle agreement on the core partition
    ref_labels, ref_core = dbscan_bruteforce_np(pts, eps, min_pts)
    core = res.core_mask.cpu().numpy()
    assert (core == ref_core).all()
    assert same_partition(res.labels.cpu().numpy()[ref_core],
                          ref_labels[ref_core])
    print("all backends agree with the brute-force oracle ✓")

    # --- sharded: shard-local trees over 4 shards of a local mesh ---
    mesh = make_local_mesh(4)
    sh = repro_torch.dbscan(pts, eps, min_pts, mesh=mesh, device=dev)
    assert sh.backend == "sharded"
    assert (sh.core_mask.cpu().numpy() == core).all()
    assert same_partition(sh.labels.cpu().numpy(), res.labels.cpu().numpy())
    print(f"{'sharded (4)':18s}: {sh.n_clusters} clusters, "
          f"{sh.n_sweeps} sweeps, same partition as fdbscan ✓")

    # --- streaming: online inserts + probe queries over a live index ---
    cut = 3 * n // 4
    stream = repro_torch.stream_handle(pts[:cut], eps, min_pts, device=dev)
    stream.insert(pts[cut:(cut + n) // 2])  # two micro-batches arrive...
    stream.insert(pts[(cut + n) // 2:])
    probes = stream.query(pts[:5])          # read-only cluster assignment
    print(f"{'streaming':18s}: {stream.n_points} pts "
          f"({stream.n_delta} in the delta tree), probe labels "
          f"{probes.labels.tolist()}")
    snap = stream.snapshot()                # = batch dbscan on the union
    batch = repro_torch.dbscan(pts, eps, min_pts, algorithm="fdbscan",
                               device=dev)
    check_component_identical(snap.labels.cpu().numpy(),
                              snap.core_mask.cpu().numpy(),
                              batch.labels.cpu().numpy(),
                              batch.core_mask.cpu().numpy())
    print("streaming snapshot matches batch dbscan ✓")

    # --- neighbor queries over the same shared index ---
    counts = repro_torch.neighbors.neighbor_count(pts, eps, device=dev)
    nn = repro_torch.neighbors.knn(pts, k=min_pts, device=dev)
    kth = nn.distances.cpu().numpy()[:, -1]
    print(f"{'neighbors':18s}: mean |N_eps| = "
          f"{float(counts.double().mean()):.1f}, "
          f"median {min_pts}-NN radius = {float(np.median(kth)):.4f} "
          f"(eps = {eps})")


if __name__ == "__main__":
    main()
