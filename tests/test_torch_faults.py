"""Kill-based crash recovery of the port's streaming index
(``repro_torch.stream``), on the CPU.

Each case runs a child process — this file, run as a script — that drives
a deterministic op schedule (inserts, deletes and an insert-order expiry
against a handle with a WAL and a checkpoint written at every merge; a
merge every third insert; a small ``buffer_max`` so tiers seal and
cascade) and arms one crash point of ``durability.FAULT_POINTS``. After
every op the child publishes the next serving snapshot of the handle
(``repro_torch.serve.TenantView.publish``, the serving plane's
``mid-publish`` barrier). The armed barrier ends the child with
``os._exit(137)``: no cleanup, no flushing, as ``kill -9``. After every op
that returned and published (an *acknowledged* op) the child appends
``op n_points n_active`` to an fsync'd ack file.
The parent then recovers from the files left behind and holds the port
to the durability contract:

  * recovery never raises on a torn or corrupt WAL tail;
  * the recovered ``(n_points, active gids)`` is the state after some op
    prefix of the schedule (no op half-applied), and that prefix covers
    every acknowledged op;
  * ``snapshot()`` is component-identical to the port's batch fdbscan on
    exactly the surviving points, and stays so after the rest of the
    schedule runs in the recovered handle.

Every fault point is covered, the serving plane's ``mid-publish``
included (the server's own crash child is in
``tests/test_torch_serve_linearizability.py``). The child imports the
port alone — no JAX, not the reference package — and checks that it did;
the schedule mirrors ``tests/faults.py``'s, which drives the reference.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = {"dataset": "blobs", "n": 240, "seed": 0, "eps": 0.05,
          "min_pts": 6, "batches": 6, "merge_every": 3,
          "checkpoint_every": 1, "buffer_max": 48}
CRASH_EXIT = 137

# (crash point, occurrence): where the durable state is most interesting —
# mid-schedule, with a checkpoint behind and WAL records in front
KILL_MATRIX = [
    ("pre-insert", 3),           # batch 3 never durable: not recovered
    ("wal-durable", 3),          # durable, unapplied: replay applies it
    ("post-insert", 3),          # applied, unacknowledged: replay again
    ("mid-merge", 2),            # merge in flight: in memory only
    ("mid-checkpoint", 2),       # torn checkpoint: the previous one + WAL
    ("mid-wal-append", 3),       # torn record on disk: truncated
    ("pre-delete", 1),           # first delete never durable
    ("wal-durable-delete", 2),   # the expiry record, durable, unapplied
    ("mid-compaction", 1),       # tier cascade in flight: in memory only
    ("mid-publish", 4),          # the third insert applied and durable,
]                                # its snapshot never swapped in


def stream_points():
    from repro_torch.data import pointclouds
    pts = pointclouds.load(CONFIG["dataset"], CONFIG["n"],
                           seed=CONFIG["seed"])
    return pts, np.array_split(np.arange(CONFIG["n"]), CONFIG["batches"])


def op_schedule():
    """Inserts, deletes of 12 seeded survivors after batches 2 and 5, the
    expiry of the first batch after batch 4 (``tests/faults.py``'s)."""
    _, batches = stream_points()
    rng = np.random.default_rng(CONFIG["seed"] + 1)
    ops, n, alive = [], 0, set()
    for i, b in enumerate(batches):
        ops.append(("insert", b))
        alive |= set(range(n, n + len(b)))
        n += len(b)
        if i in (1, 4):
            gids = np.sort(rng.choice(np.array(sorted(alive)), size=12,
                                      replace=False))
            ops.append(("delete", gids))
            alive -= set(int(g) for g in gids)
        elif i == 3:
            wm = int(len(batches[0]))
            ops.append(("expire", wm))
            alive -= set(range(wm))
    return ops


def expected_states():
    """(n_points, frozenset(active gids)) after each op prefix."""
    states = [(0, frozenset())]
    n, alive = 0, set()
    for kind, arg in op_schedule():
        if kind == "insert":
            alive |= set(range(n, n + len(arg)))
            n += len(arg)
        elif kind == "delete":
            alive -= set(int(g) for g in arg)
        else:
            alive -= set(range(arg))
        states.append((n, frozenset(alive)))
    return states


def paths(workdir):
    return (os.path.join(workdir, "ckpt.npz"),
            os.path.join(workdir, "wal.bin"),
            os.path.join(workdir, "acks.txt"))


def _apply(h, op, pts):
    kind, arg = op
    if kind == "insert":
        h.insert(pts[arg])
    elif kind == "delete":
        h.delete(arg)
    else:
        h.expire(arg)


# --------------------------------------------------------------------- #
# the child                                                             #
# --------------------------------------------------------------------- #

def child_main(workdir: str, point: str | None, at: int) -> int:
    from repro_torch.serve import TenantSpec, TenantView
    from repro_torch.stream import StreamingDBSCAN, durability
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    if loaded:
        print(f"the child loaded {loaded}", file=sys.stderr)
        return 3
    pts, _ = stream_points()
    ckpt, wal, ack_path = paths(workdir)
    h = StreamingDBSCAN(None, CONFIG["eps"], CONFIG["min_pts"], wal=wal,
                        checkpoint_path=ckpt,
                        checkpoint_every=CONFIG["checkpoint_every"],
                        buffer_max=CONFIG["buffer_max"], device="cpu")
    view = TenantView(TenantSpec("t", CONFIG["eps"], CONFIG["min_pts"]), h)
    durability.arm_fault(point, at=at)
    n_inserts = 0
    with open(ack_path, "a") as acks:
        for i, op in enumerate(op_schedule()):
            _apply(h, op, pts)          # may os._exit(137) at the barrier
            view.publish()              # the mid-publish barrier
            acks.write(f"{i} {h.n_points} {h.n_active}\n")
            acks.flush()
            os.fsync(acks.fileno())
            if op[0] == "insert":
                n_inserts += 1
                if n_inserts % CONFIG["merge_every"] == 0:
                    h.merge()           # the merge and checkpoint barriers
    durability.arm_fault(None)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _, workdir, point, at = sys.argv
    sys.exit(child_main(workdir, None if point == "none" else point,
                        int(at)))


# --------------------------------------------------------------------- #
# the parent                                                            #
# --------------------------------------------------------------------- #

import pytest  # noqa: E402

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.validate import check_component_identical  # noqa: E402
from repro_torch.stream import StreamingDBSCAN, durability  # noqa: E402

CASES = KILL_MATRIX + [(None, 1)]


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child of the matrix (and one clean run), started together:
    each spends most of its few seconds importing torch."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for point, at in CASES:
        wd = tmp_path_factory.mktemp(f"{point or 'clean'}-{at}")
        procs[(point, at)] = (wd, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(wd),
             point or "none", str(at)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for key, (wd, p) in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[key] = (wd, p.returncode, stderr)
    return out


def read_acks(workdir):
    _, _, ack_path = paths(workdir)
    if not os.path.exists(ack_path):
        return []
    with open(ack_path) as f:
        return [tuple(int(x) for x in line.split()) for line in f]


def _match_prefix(h):
    got = (h.n_points, frozenset(int(g) for g in h.active_gids))
    for k, s in enumerate(expected_states()):
        if s == got:
            return k
    raise AssertionError(f"recovered state (n_points={got[0]}, n_active="
                         f"{len(got[1])}) matches no op prefix: an op was "
                         "half-applied or the active set drifted")


def _check_snapshot(h, pts):
    alive = np.asarray(sorted(int(g) for g in h.active_gids))
    snap = h.snapshot()
    ref = dispatch.dbscan(pts[alive], CONFIG["eps"], CONFIG["min_pts"],
                          algorithm="fdbscan", device="cpu")
    check_component_identical(snap.labels.numpy(), snap.core_mask.numpy(),
                              ref.labels.numpy(), ref.core_mask.numpy())


def recover_and_check(workdir):
    ckpt, wal, _ = paths(workdir)
    pts, _ = stream_points()
    acked = read_acks(workdir)
    h = StreamingDBSCAN.restore(ckpt, wal=wal, device="cpu",
                                checkpoint_every=CONFIG["checkpoint_every"])
    k = _match_prefix(h)
    assert k >= len(acked), (f"recovered {k} ops but {len(acked)} were "
                             "acknowledged: an acknowledged op was lost")
    states = expected_states()
    for i, n_points, n_active in acked:
        assert (n_points, n_active) == (states[i + 1][0],
                                        len(states[i + 1][1]))
    if h.n_active:
        _check_snapshot(h, pts)
    return h, k


def finish_stream(h, k):
    pts, _ = stream_points()
    for op in op_schedule()[k:]:
        _apply(h, op, pts)
    assert h.n_points == CONFIG["n"]
    assert (frozenset(int(g) for g in h.active_gids)
            == expected_states()[-1][1])
    _check_snapshot(h, pts)


@pytest.mark.parametrize("point,at", CASES,
                         ids=[f"{p}@{a}" if p else "clean" for p, a in CASES])
def test_kill_and_recover(children, point, at):
    wd, rc, stderr = children[(point, at)]
    want = 0 if point is None else CRASH_EXIT
    assert rc == want, f"child {point}@{at}: rc {rc}\n{stderr}"
    h, k = recover_and_check(str(wd))
    if point is None:
        assert k == len(op_schedule()) == len(read_acks(str(wd)))
    h._wal = None               # finish without appending to the files
    finish_stream(h, k)


def test_matrix_covers_every_stream_fault_point():
    assert {p for p, _ in KILL_MATRIX} == set(durability.FAULT_POINTS)


@pytest.mark.parametrize("tail", [
    b"\x52\x45\x43\x57" + b"\x00" * 9,      # torn mid-header
    b"\x52\x45\x43\x57" + b"\x00" * 40,     # full header, torn payload
    b"not-a-record-at-all",                 # garbage
], ids=["torn-header", "torn-payload", "garbage"])
def test_torn_final_record_is_truncated(children, tmp_path, tail):
    """A partial final record (a crash mid-append) is dropped silently and
    every acknowledged op before it survives; the log then takes appends
    again."""
    import shutil
    src, _, _ = children[("pre-insert", 3)]
    for name in ("wal.bin", "acks.txt"):   # no checkpoint yet: WAL only
        shutil.copy(os.path.join(src, name), tmp_path / name)
    _, wal, _ = paths(str(tmp_path))
    with open(wal, "ab") as f:
        f.write(tail)
    h, k = recover_and_check(str(tmp_path))
    assert h.n_points == max(a[1] for a in read_acks(str(tmp_path)))
    finish_stream(h, k)         # appends through the truncated log
    h._wal.close()
    h2 = StreamingDBSCAN.restore(paths(str(tmp_path))[0], wal=wal,
                                 device="cpu")
    assert h2.n_points == CONFIG["n"]
