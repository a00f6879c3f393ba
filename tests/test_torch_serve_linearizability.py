"""Linearizability of the port's snapshot publish/read path
(``repro_torch.serve``), on the CPU.

The serving contract: every query executes against exactly one
*published* snapshot version — never a torn intermediate — and the
version sequence any single client observes is monotonic. The attack
angles of ``tests/test_serve_linearizability.py``, on the port:

  * **randomized interleaving** — reader threads hammer
    ``SnapshotStore.current`` while a writer publishes a known sequence of
    versions; every answer must be byte-equal to the reference computed
    for the version the reader saw *before* it was published (and that
    reference equals the reference package's snapshot over the same
    frozen state), and per-reader versions never go backwards;
  * **kill mid-publish** — a child process (this file, run as a script;
    it imports the port alone) serving two tenants arms the
    ``mid-publish`` durability barrier, between snapshot build and the
    atomic swap, and dies there with ``os._exit(137)``. The WAL-durable
    insert that triggered the publish must survive ``Server.restore``,
    whose answers equal handles replayed to the same watermark. Killed at
    ``post-insert`` instead, after the first tenant applied the batch and
    before the second did, the restore tops the second tenant up from the
    first's stream;
  * **many clients** — more client threads than cores, with a short
    thread switch interval, submit queries at once: every reply arrives
    and the admission budgets return to zero.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS, MINPTS = 0.05, 6
CRASH_EXIT = 137


TENANTS = [("t", EPS, MINPTS), ("u", 0.08, 4)]


def child_main(workdir: str, point: str) -> int:
    from repro_torch.data import pointclouds
    from repro_torch.serve import Server
    from repro_torch.stream import durability
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    if loaded:
        print(f"the child loaded {loaded}", file=sys.stderr)
        return 3
    pts = pointclouds.load("blobs", 300, seed=40)
    srv = Server(pts[:200], TENANTS, durability_dir=workdir,
                 checkpoint_every=1, device="cpu")
    durability.arm_fault(point, at=1)           # armed AFTER the bootstrap
    srv.submit_insert(pts[200:260])             # the writer dies at it
    time.sleep(60)                              # the writer thread kills us
    return 1                                    # survived: the test fails


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.exit(child_main(sys.argv[1], sys.argv[2]))


import threading  # noqa: E402

import pytest  # noqa: E402

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro.serve import snapshot as jsnapshot  # noqa: E402

from repro_torch.core import dispatch  # noqa: E402
from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Server, ServerConfig, SnapshotStore, freeze)


def _assert_same(ref, got, what):
    for f in ("labels", "counts", "would_be_core"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f),
                                      err_msg=f"{what}: {f} diverged")


def test_interleaved_readers_always_see_a_published_version():
    pts = pointclouds.load("blobs", 500, seed=30)
    h = dispatch.stream_handle(pts[:200], EPS, MINPTS, device="cpu")
    store = SnapshotStore(keep=32)
    probes = np.ascontiguousarray(pts[::7][:64], np.float32)

    refs = {}                       # version -> reference QueryResult,
                                    # filled BEFORE the version publishes

    def frozen(v):
        snap = freeze(h, version=v)
        state = h.freeze_view()
        refs[v] = snap.query(probes)
        _assert_same(jsnapshot.IndexSnapshot(
            state.pts.numpy(), state.vals.numpy(), EPS, MINPTS).query(probes),
            refs[v], f"v{v} against the reference snapshot")
        return snap

    store.publish(frozen(0))
    stop = threading.Event()
    errors: list = []
    observed = [0, 0]

    def reader(slot):
        last = -1
        try:
            while not stop.is_set():
                snap = store.current()
                v = snap.version
                assert v >= last, f"reader saw v{v} after v{last}"
                last = v
                res = snap.query(probes)
                _assert_same(refs[v], res, f"v{v} under interleaving")
                observed[slot] += 1
                # yield the interpreter lock now and then: the writer's
                # insert is many short torch calls, each of which must
                # take the lock back
                time.sleep(0.002)
        except Exception as e:      # pragma: no cover — failure path
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    try:
        for v in range(1, 10):      # writer: publish a known sequence
            h.insert(pts[200 + 30 * (v - 1):200 + 30 * v])
            store.publish(frozen(v))
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert store.version == 9
    assert min(observed) > 0        # both readers actually raced the writer
    for v in range(10):             # the retained history is exactly the
        kept = store.get(v)         # published snapshots
        assert kept is not None and kept.version == v


@pytest.mark.parametrize("point", ["mid-publish", "post-insert"])
def test_kill_mid_publish_recovers_old_view_plus_durable_insert(tmp_path,
                                                                point):
    """Crash between snapshot build and swap (or between the tenants'
    applies): the insert is already WAL-durable in the first tenant (the
    handle logs it before it applies it), the new snapshot never
    published. Recovery serves the whole durable stream to every
    tenant."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(tmp_path), point], cwd=ROOT, env=env,
                          timeout=300, capture_output=True, text=True)
    assert proc.returncode == CRASH_EXIT, (
        f"child did not die at the {point} barrier:\n"
        f"rc={proc.returncode}\nstdout={proc.stdout}\nstderr={proc.stderr}")

    pts = pointclouds.load("blobs", 300, seed=40)
    srv = Server.restore(TENANTS, durability_dir=str(tmp_path),
                         checkpoint_every=1, device="cpu")
    try:
        probes = np.ascontiguousarray(pts[::5][:64], np.float32)
        for view, (name, eps, mp) in zip(srv._views, TENANTS):
            # the insert hit the first tenant's WAL before the barrier: the
            # recovered state is the whole 260-point stream, not just the
            # bootstrap, in every tenant (topped up where it lagged)
            assert view.handle.n_points == 260, name
            assert view.store.version == 0      # fresh publish, new counter
            replay = dispatch.stream_handle(pts[:200], eps, mp, device="cpu")
            replay.insert(pts[200:260])
            _assert_same(freeze(replay).query(probes),
                         srv.query(probes, tenant=name, timeout=120),
                         f"{name} after recovery")
            assert (view.handle.freeze_view().vals
                    == replay.freeze_view().vals).all()
    finally:
        srv.shutdown(final_checkpoint=False)


def test_many_clients_balance_admission():
    pts = pointclouds.load("blobs", 300, seed=41)
    n_clients = 4 * (os.cpu_count() or 4)
    srv = Server(pts, [("t", EPS, MINPTS)], device="cpu",
                 config=ServerConfig(max_batch=256, max_delay_s=0.001,
                                     max_pending_requests=4 * n_clients))
    want = freeze(srv._views[0].handle).query(pts[:40])
    errors: list = []
    done = [0] * n_clients
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(i):
            try:
                for j in range(5):
                    lo = (i + j) % 20
                    rep = srv.query(pts[lo:lo + 20], timeout=60)
                    _assert_same(type(want)(*(x[lo:lo + 20] for x in want)),
                                 rep, f"client {i}")
                    done[i] += 1
            except Exception as e:  # pragma: no cover — failure path
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(prev)
        srv.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert done == [5] * n_clients
    st = srv.stats()
    assert st["pending_requests"] == 0 and st["pending_points"] == 0
    assert st["completed"]["query"] == 5 * n_clients
