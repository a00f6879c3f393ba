"""The port's durability layer (``repro_torch.stream.durability``) against
the reference's (``repro.stream.durability``), on the CPU, zero tolerance.

The on-disk format is one format: the port restores the golden fixtures
(``tests/golden/stream_ckpt_v1.npz``, ``stream_ckpt_v2.npz``,
``stream_wal_v1.bin``, ``stream_wal_v2.bin``) to the state the reference
restores; after the same op sequence both packages' WAL files are equal
byte for byte; a checkpoint either package writes restores in the other
to equal state and snapshots (checkpoint bytes are not compared with the
golden file: the zip header of ``np.savez`` differs between machines).
A torn WAL tail is truncated silently and a damaged checkpoint raises
``CheckpointError``. Crash recovery is in ``tests/test_torch_faults.py``.
"""
import io
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several worker processes that
# share the host's cores, and a torch thread pool in each oversubscribes
# them (the whole suite, six workers on 8 cores: 1430 s with them, 917 s
# without).
torch.set_num_threads(1)

from repro.stream import StreamingDBSCAN as JStream  # noqa: E402
from repro.stream import durability as jdurability  # noqa: E402

from repro_torch.data import pointclouds  # noqa: E402
from repro_torch.stream import StreamingDBSCAN, durability  # noqa: E402

from test_torch_stream import (_assert_same_snapshot,  # noqa: E402
                               _assert_same_state)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# tests/golden/make_stream_golden.py's stream and parameters
G_EPS, G_MIN_PTS, G_N_CKPT, G_N_TOTAL = 0.05, 6, 80, 100
EPS, MIN_PTS = 0.05, 6


def golden_stream():
    return pointclouds.blobs(G_N_TOTAL, k=3, seed=7)


def _copy(tmp_path, *names):
    out = []
    for name in names:
        if name is None:
            out.append(None)
            continue
        shutil.copy(os.path.join(GOLDEN, name), tmp_path / name)
        out.append(str(tmp_path / name))
    return out


def _restore_both(ckpt, wal):
    ref = JStream.restore(ckpt, wal=wal)
    port = StreamingDBSCAN.restore(ckpt, wal=wal, device="cpu")
    for h in (ref, port):
        if h._wal is not None:
            h._wal.close()
    return ref, port


@pytest.mark.parametrize("ckpt,wal,n_points", [
    ("stream_ckpt_v1.npz", None, G_N_CKPT),
    ("stream_ckpt_v1.npz", "stream_wal_v1.bin", G_N_TOTAL),
    ("stream_ckpt_v2.npz", None, G_N_CKPT),
    ("stream_ckpt_v2.npz", "stream_wal_v2.bin", G_N_TOTAL),
], ids=["ckpt_v1", "ckpt_v1+wal_v1", "ckpt_v2", "ckpt_v2+wal_v2"])
def test_golden_files_restore_like_reference(tmp_path, ckpt, wal, n_points):
    ckpt, wal = _copy(tmp_path, ckpt, wal)
    ref, port = _restore_both(ckpt, wal)
    assert port.n_points == n_points
    assert (port.eps, port.min_pts) == (G_EPS, G_MIN_PTS)
    _assert_same_state(ref, port, "restored")
    _assert_same_snapshot(ref.snapshot(), port.snapshot(), "restored")
    np.testing.assert_array_equal(port.points,
                                  golden_stream()[port.active_gids])


@pytest.mark.parametrize("wal", ["stream_wal_v1.bin", "stream_wal_v2.bin"])
def test_golden_wal_alone_is_a_gap_in_both(tmp_path, wal):
    """The golden logs start past watermark 0: without their checkpoint
    both packages refuse to replay them."""
    (wal,) = _copy(tmp_path, wal)
    with pytest.raises(jdurability.WALError, match="prefix is missing"):
        JStream.restore(None, wal=wal)
    with pytest.raises(durability.WALError, match="prefix is missing"):
        StreamingDBSCAN.restore(None, wal=wal, device="cpu")


def _sequence(h, pts):
    """One op sequence over every record type and both barriers of the
    configured checkpoint (which resets the WAL)."""
    h.insert(pts[120:150])
    h.delete(np.array([3, 40, 121, 149]))
    h.expire(10)
    h.checkpoint()
    h.insert(pts[150:180])
    h.delete(np.array([11, 12, 151]))
    h.expire(25)
    h.insert(pts[180:200])


@pytest.mark.parametrize("with_ckpt", [False, True],
                         ids=["wal_only", "wal+checkpoint"])
def test_wal_bytes_equal_reference(tmp_path, with_ckpt):
    pts = pointclouds.blobs(200, k=3, seed=5)
    files = {}
    handles = {}
    for side, cls, kw in (("ref", JStream, {}), ("port", StreamingDBSCAN,
                                                 {"device": "cpu"})):
        wal = str(tmp_path / f"{side}.wal")
        ckpt = str(tmp_path / f"{side}.npz") if with_ckpt else None
        h = cls(pts[:120], EPS, MIN_PTS, wal=wal, checkpoint_path=ckpt,
                buffer_max=24, **kw)
        if with_ckpt:
            _sequence(h, pts)
        else:
            h.insert(pts[120:150])
            h.delete(np.array([3, 40, 121, 149]))
            h.expire(10)
            h.insert(pts[150:200])
        h._wal.close()
        files[side] = open(wal, "rb").read()
        handles[side] = h
    assert len(files["port"]) > 100
    assert files["port"] == files["ref"]
    _assert_same_state(handles["ref"], handles["port"], "after the ops")


def test_checkpoints_cross_restore(tmp_path):
    """A checkpoint the port writes restores in the reference, and one the
    reference writes restores in the port, to equal state and snapshots;
    both packages write the same manifest, checksum included."""
    pts = pointclouds.blobs(200, k=3, seed=5)
    ref = JStream(pts[:120], EPS, MIN_PTS, buffer_max=24)
    port = StreamingDBSCAN(pts[:120], EPS, MIN_PTS, buffer_max=24,
                           device="cpu")
    for h in (ref, port):
        h.insert(pts[120:170])
        h.delete(np.array([0, 5, 130, 160]))
        h.expire(8)
    _assert_same_state(ref, port, "live")
    m_port = port.checkpoint(str(tmp_path / "port.npz"))
    m_ref = ref.checkpoint(str(tmp_path / "ref.npz"))
    assert m_port == m_ref
    in_ref = JStream.restore(str(tmp_path / "port.npz"))
    in_port = StreamingDBSCAN.restore(str(tmp_path / "ref.npz"),
                                      device="cpu")
    _assert_same_state(in_ref, in_port, "cross-restored")
    for h in (in_ref, in_port):     # gids 0 and 5 die twice
        assert h.n_points == 170 and h.n_tombstoned == 4 + 8 - 2
    _assert_same_snapshot(in_ref.snapshot(), in_port.snapshot(), "cross")
    _assert_same_snapshot(ref.snapshot(), in_port.snapshot(), "live")
    # and the restored handles keep taking ops alike
    for h in (in_ref, in_port):
        h.insert(pts[170:200])
    _assert_same_state(in_ref, in_port, "after an insert")


@pytest.mark.parametrize("tail", [
    b"\x52\x45\x43\x57" + b"\x00" * 9,      # torn mid-header
    b"\x52\x45\x43\x57" + b"\x00" * 40,     # full header, torn payload
    b"not-a-record-at-all",                 # garbage
], ids=["torn-header", "torn-payload", "garbage"])
def test_torn_wal_tail_truncated_silently(tmp_path, tail):
    ckpt, wal = _copy(tmp_path, "stream_ckpt_v2.npz", "stream_wal_v2.bin")
    whole = os.path.getsize(wal)
    with open(wal, "ab") as f:
        f.write(tail)
    header, ops, valid_end = durability.scan_wal(wal)
    assert (header, valid_end) == (jdurability.scan_wal(wal)[0], whole)
    assert len(ops) == 4
    ref, port = _restore_both(ckpt, wal)
    assert port.n_points == G_N_TOTAL
    _assert_same_state(ref, port, "torn tail")
    # the next append truncates the tail first
    port._wal = durability.WriteAheadLog(wal, eps=G_EPS, min_pts=G_MIN_PTS)
    port.insert(golden_stream()[:5])
    port._wal.close()
    assert durability.scan_wal(wal)[2] == os.path.getsize(wal) > whole


def _rewrite(src, out_path, *, version=None, corrupt=None, cut=False):
    """Copy a checkpoint, stamping a new manifest version, flipping one
    array element (the checksum left stale), or cutting it in half."""
    blob = open(src, "rb").read()
    if cut:
        open(out_path, "wb").write(blob[:len(blob) // 2])
        return
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays["manifest"]).decode())
    if version is not None:
        manifest["version"] = version
    if corrupt is not None:
        arr = arrays[corrupt].copy()
        arr.flat[0] += 1
        arrays[corrupt] = arr
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest, sort_keys=True).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    open(out_path, "wb").write(buf.getvalue())


@pytest.mark.parametrize("damage,match", [
    (dict(corrupt="counts"), "checksum mismatch"),
    (dict(corrupt="labels"), "checksum mismatch"),
    (dict(version=durability.CHECKPOINT_VERSION + 41), "unsupported"),
    (dict(cut=True), "unreadable"),
], ids=["counts", "labels", "future-version", "truncated"])
def test_damaged_checkpoint_raises(tmp_path, damage, match):
    p = str(tmp_path / "bad.npz")
    _rewrite(os.path.join(GOLDEN, "stream_ckpt_v2.npz"), p, **damage)
    with pytest.raises(durability.CheckpointError, match=match):
        StreamingDBSCAN.restore(p, device="cpu")
    with pytest.raises(jdurability.CheckpointError, match=match):
        JStream.restore(p)


def test_handle_refuses_a_dirty_wal(tmp_path):
    (wal,) = _copy(tmp_path, "stream_wal_v2.bin")
    with pytest.raises(durability.WALError, match="previous run"):
        StreamingDBSCAN(None, G_EPS, G_MIN_PTS, wal=wal, device="cpu")


def test_format_constants_match_reference():
    assert durability.CHECKPOINT_VERSION == jdurability.CHECKPOINT_VERSION
    assert durability.WAL_VERSION == jdurability.WAL_VERSION
    assert durability.FAULT_POINTS == jdurability.FAULT_POINTS
    assert durability._HDR.format == jdurability._HDR.format
    assert durability._REC2.format == jdurability._REC2.format
