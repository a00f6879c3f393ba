"""The port's sharded tree path (``repro_torch.distributed``) on the CPU
against the reference's *live* sharded programs, P = 8 shards.

The oracle: one subprocess a test module, under 8 forced host devices,
calls ``repro.distributed.ring_dbscan._sharded_programs`` directly and
reads every sharded output through ``np.asarray``, then finalizes the host
copies with the reference's ``_finalize``. (Under jax 0.9 the shard_map
programs run; only host-side indexing of a sharded output raises
``ShardingTypeError``, inside ``tree_dbscan_sharded`` and ``ring_dbscan``.)
``ring_dbscan`` runs with the module's ``jax`` replaced by a proxy whose
``jit`` hands back host copies. Nothing in ``src/repro`` changes. The
subprocess starts when the module's fixture is set up and runs while the
port computes.

The port runs the same phases over a ``sharding.LocalMesh(8)``
(``ring_dbscan.ShardedProgram``: build, one call a sweep, border) with the
plain engine. Held byte-equal, zero tolerance: labels, core mask,
``n_clusters``, ``n_sweeps`` and every phase's per-lane ``evals``; and
``tree_dbscan_sharded(with_stats=True)``'s statistics.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.distributed import ring_dbscan as rd, sharding  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (dataset, n, eps, min_pts): tests/test_ring_tree.py's SCENARIOS
SCENARIOS = [
    ("ngsim_like", 1600, 0.01, 5),
    ("portotaxi_like", 1600, 0.02, 5),
    ("road3d_like", 1600, 0.01, 5),
    ("hacc_like", 1600, 0.05, 5),
    ("blobs", 1600, 0.05, 8),
]
HERE_CASES = SCENARIOS[:3]

# The oracle program: reads the cases and their points from argv[1] (an
# .npz with a JSON "cases" entry) and writes each case's "<name>/<field>"
# arrays to "<argv[2]>/<name>.npz" as soon as it has them.
ORACLE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.core import morton
from repro.core.fdbscan import _finalize
from repro.distributed import ring_dbscan as rd


def mesh_of(ndev):
    return Mesh(np.array(jax.devices()[:ndev]), ("data",))


def result(labels, core, n_clusters, n_sweeps):
    return {"labels": np.asarray(labels), "core": np.asarray(core),
            "n_clusters": np.int64(n_clusters),
            "n_sweeps": np.int64(n_sweeps)}


def sharded(c, pts):
    pts = jnp.asarray(pts, jnp.float32)
    n, ndev = pts.shape[0], c["ndev"]
    ps, order, _ = morton.morton_sort(pts)
    n_pad = -(-n // ndev) * ndev
    pp = jnp.pad(ps, ((0, n_pad - n), (0, 0)), constant_values=1e30)
    build, sweep, border = rd._sharded_programs(
        mesh_of(ndev), "data", n, n_pad, float(c["eps"]), int(c["min_pts"]))
    idx, core, labels, ev = build(pp)
    evals = [np.asarray(ev)]
    while True:
        labels, changed, ev = sweep(pp, idx, core, labels)
        evals.append(np.asarray(ev))
        if not np.asarray(changed)[0]:
            break
    labels, ev = border(pp, idx, core, labels)
    evals.append(np.asarray(ev))
    lab, n_clusters = _finalize(np.asarray(labels)[:n], order, n)
    cm = np.zeros(n, bool)
    cm[np.asarray(order)] = np.asarray(core)[:n]
    out = result(lab, cm, n_clusters, len(evals) - 2)
    out["evals"] = np.stack(evals)
    return out


class HostJit:
    """jax, with a jit whose programs hand back host copies."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        f = jax.jit(fn, **kw)
        return lambda *a: jax.tree_util.tree_map(np.asarray, f(*a))


rd.jax = HostJit()


def ring(c, pts):
    r = rd.ring_dbscan(pts, c["eps"], c["min_pts"], mesh=mesh_of(c["ndev"]),
                       use_pallas=c["use_pallas"])
    return result(r.labels, r.core_mask, r.n_clusters, r.n_sweeps)


def fallback(c, pts):
    r, st = rd.tree_dbscan_sharded(pts, c["eps"], c["min_pts"],
                                   mesh=mesh_of(c["ndev"]), with_stats=True)
    out = result(r.labels, r.core_mask, r.n_clusters, r.n_sweeps)
    out["stats"] = np.asarray([st["distance_evals"],
                               st["ring_distance_evals"], st["ndev"],
                               st["n_pad"], st["n_sweeps"]], np.int64)
    return out


inp = np.load(sys.argv[1])
for c in json.loads(str(inp["cases"])):
    fn = {"sharded": sharded, "ring": ring, "fallback": fallback}[c["kind"]]
    out = {c["name"] + "/" + k: v for k, v in fn(c, inp[c["name"]]).items()}
    dst = os.path.join(sys.argv[2], c["name"])
    np.savez(dst + ".tmp.npz", **out)
    os.replace(dst + ".tmp.npz", dst + ".npz")
'''


class JaxOracle:
    """The reference's answers to a module's cases, computed in one
    subprocess under 8 forced host devices (started at construction; each
    case's answers are read by :meth:`get` once the subprocess has them).

    ``cases``: dicts with ``kind`` ("sharded", "ring" or "fallback"),
    ``name``, ``eps``, ``min_pts``, ``ndev`` (and ``use_pallas`` for a
    ring); ``points``: ``{name: (n, d) float32}``."""

    def __init__(self, tmpdir, cases, points):
        self._dir = tmpdir
        src = os.path.join(tmpdir, "oracle_in.npz")
        np.savez(src, cases=json.dumps(cases), **points)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        self._log = open(os.path.join(tmpdir, "oracle.log"), "w+")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", ORACLE, src, tmpdir], env=env,
            stdout=self._log, stderr=subprocess.STDOUT)

    def get(self, name: str) -> dict:
        """The reference's ``<name>/<field>`` arrays for case ``name``."""
        path = os.path.join(self._dir, name + ".npz")
        deadline = time.monotonic() + 600
        while not os.path.exists(path):
            rc = self._proc.poll()
            if rc is not None and not os.path.exists(path):
                self._log.seek(0)
                raise AssertionError(f"oracle exited {rc} without {name}:\n"
                                     + self._log.read()[-4000:])
            assert time.monotonic() < deadline, "oracle timed out"
            time.sleep(0.05)
        return dict(np.load(path))

    def close(self):
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.wait()
        self._log.close()


def sharded_case(name, eps, min_pts, ndev=8):
    return {"kind": "sharded", "name": name, "eps": eps, "min_pts": min_pts,
            "ndev": ndev}


def run_programs(pts, eps, min_pts, ndev=8):
    """The port's phases on a local mesh, driven as the reference's host
    loop drives them. Returns (result, per-phase evals (phases, n_pad))."""
    mesh = sharding.LocalMesh(ndev)
    p = torch.from_numpy(np.ascontiguousarray(pts, np.float32))
    n = p.shape[0]
    pts_pad, order, n_pad = rd._pad(p, ndev)
    prog = rd.ShardedProgram(mesh, "data", n, n_pad, eps, min_pts)
    local = rd._slabs(mesh, "data", pts_pad, prog.n_loc)
    idx, core, labels, ev = prog.build(local)
    evals = [torch.cat(ev)]
    while True:
        labels, changed, ev = prog.sweep(local, idx, core, labels)
        evals.append(torch.cat(ev))
        if not changed:
            break
    labels, ev = prog.border(local, idx, core, labels)
    evals.append(torch.cat(ev))
    res = rd._result(mesh, "data", labels, core, order, n, len(evals) - 2,
                     "sharded")
    return res, torch.stack(evals).numpy()


def assert_same(res, want, name):
    np.testing.assert_array_equal(res.labels.numpy(), want[name + "/labels"])
    np.testing.assert_array_equal(res.core_mask.numpy(),
                                  want[name + "/core"])
    assert res.labels.dtype == torch.int32
    assert res.n_clusters == int(want[name + "/n_clusters"])
    assert res.n_sweeps == int(want[name + "/n_sweeps"])


def assert_same_evals(evals, want, name):
    ref = want[name + "/evals"]
    assert evals.shape == ref.shape, (evals.shape, ref.shape)
    np.testing.assert_array_equal(evals, ref)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    cases = [sharded_case(d, eps, mp) for d, _, eps, mp in HERE_CASES]
    points = {d: pointclouds.load(d, n) for d, n, _, _ in HERE_CASES}
    o = JaxOracle(str(tmp_path_factory.mktemp("oracle")), cases, points)
    yield o
    o.close()


@pytest.mark.parametrize("dset,n,eps,mp", HERE_CASES,
                         ids=[s[0] for s in HERE_CASES])
def test_sharded_matches_live_reference(oracle, dset, n, eps, mp):
    res, evals = run_programs(pointclouds.load(dset, n), eps, mp)
    want = oracle.get(dset)
    assert_same(res, want, dset)
    assert_same_evals(evals, want, dset)


def test_tree_dbscan_sharded_stats_match_reference(oracle):
    dset, n, eps, mp = HERE_CASES[2]
    res, st = rd.tree_dbscan_sharded(pointclouds.load(dset, n), eps, mp,
                                     mesh=sharding.LocalMesh(8),
                                     with_stats=True, device="cpu")
    want = oracle.get(dset)
    assert_same(res, want, dset)
    assert res.backend == "sharded"
    assert st == {"distance_evals": int(want[dset + "/evals"].sum()),
                  "ring_distance_evals": (2 + res.n_sweeps) * n * n,
                  "ndev": 8, "n_pad": n, "n_sweeps": res.n_sweeps}
    # the tree path beats the dense ring's work by a wide margin
    assert st["distance_evals"] * 5 < st["ring_distance_evals"]
