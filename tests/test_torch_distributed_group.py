"""The group mesh: one shard a rank of a ``torch.distributed`` process group
over gloo, in processes of their own, on the CPU.

Each rank passes the whole point set (SPMD), keeps its slab and returns the
whole result. ``tree_dbscan_sharded`` (with its statistics), ``ring_dbscan``
and ``repro_torch.dbscan(mesh=...)`` on every rank must equal the same call
on a ``LocalMesh`` with the same number of shards, byte for byte: P = 2 and
P = 3 ranks, and 4 ranks as a (data, model) = (2, 2) mesh, whose rings run
over subgroups. The group is set up from a file under the test's temporary
directory (``init_method="file://..."``), so no port is needed.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

import repro_torch  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.distributed import ring_dbscan as rd, sharding  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS, MIN_PTS = 0.05, 5

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    rank, world, model, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    import repro_torch
    from repro_torch.distributed.ring_dbscan import (ring_dbscan,
                                                     tree_dbscan_sharded)
    from repro_torch.launch.mesh import make_host_mesh
    eps, mp = float(sys.argv[5]), int(sys.argv[6])
    pts = np.load(f"{tmp}/pts.npy")
    mesh = make_host_mesh(model)
    res, st = tree_dbscan_sharded(pts, eps, mp, mesh=mesh, with_stats=True,
                                  device="cpu")
    ring = ring_dbscan(pts, eps, mp, mesh=mesh, device="cpu")
    auto = repro_torch.dbscan(pts, eps, mp, mesh=mesh, device="cpu")
    np.savez(f"{tmp}/rank{rank}.npz", labels=res.labels.numpy(),
             core=res.core_mask.numpy(),
             meta=np.asarray([res.n_clusters, res.n_sweeps,
                              st["distance_evals"], st["ring_distance_evals"],
                              st["ndev"], st["n_pad"], st["n_sweeps"]]),
             ring_labels=ring.labels.numpy(), ring_core=ring.core_mask.numpy(),
             ring_meta=np.asarray([ring.n_clusters, ring.n_sweeps]),
             auto_labels=auto.labels.numpy(),
             auto_backend=np.asarray(auto.backend))
    dist.barrier()
    dist.destroy_process_group()
""")


def _run_group(tmp, world, model, pts):
    np.save(os.path.join(tmp, "pts.npy"), pts)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(model), tmp,
         str(EPS), str(MIN_PTS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out}"
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(world)]


@pytest.mark.parametrize("world,model", [(2, 1), (3, 1), (4, 2)],
                         ids=["p2", "p3", "p2x2"])
def test_group_mesh_equals_local_mesh(tmp_path, world, model):
    pts = pointclouds.load("hacc_like", 600)
    shards = world // model
    local = sharding.LocalMesh(shards)
    want, st = rd.tree_dbscan_sharded(pts, EPS, MIN_PTS, mesh=local,
                                      with_stats=True, device="cpu")
    ring = rd.ring_dbscan(pts, EPS, MIN_PTS, mesh=sharding.LocalMesh(shards),
                          device="cpu")
    auto = repro_torch.dbscan(pts, EPS, MIN_PTS,
                              mesh=sharding.LocalMesh(shards), device="cpu")
    for r, got in enumerate(_run_group(str(tmp_path), world, model, pts)):
        np.testing.assert_array_equal(got["labels"], want.labels.numpy())
        np.testing.assert_array_equal(got["core"], want.core_mask.numpy())
        assert got["meta"].tolist() == [
            want.n_clusters, want.n_sweeps, st["distance_evals"],
            st["ring_distance_evals"], st["ndev"], st["n_pad"],
            st["n_sweeps"]], r
        np.testing.assert_array_equal(got["ring_labels"],
                                      ring.labels.numpy())
        np.testing.assert_array_equal(got["ring_core"],
                                      ring.core_mask.numpy())
        assert got["ring_meta"].tolist() == [ring.n_clusters, ring.n_sweeps]
        np.testing.assert_array_equal(got["auto_labels"], auto.labels.numpy())
        assert str(got["auto_backend"]) == "sharded"
