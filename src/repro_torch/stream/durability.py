"""Durability layer for the streaming index (DESIGN.md §10).

The port's copy of the reference's host code
(``repro.stream.durability``): the on-disk format is the same byte for
byte — checkpoint manifest keys, content checksum, WAL magic, headers and
record CRCs — so a checkpoint or log written by either package restores
in the other. The handle's state lives in device tensors; a checkpoint
takes host (numpy) copies of them at this boundary.

The serving path keeps its whole state — points, saturated core counts,
union-find labels, the tombstone mask, the tiered tree split — in process
memory; a crash mid-merge or mid-insert loses everything accumulated
since boot.  This module makes the handle crash-safe with the classic
pairing:

  * **Checkpoints** — :func:`save_checkpoint` serializes the full handle
    state to a single ``.npz`` (arrays + a JSON manifest carrying a format
    version, the DBSCAN parameters, the insert-order *watermark*, the
    expiry watermark and a content checksum) with an atomic write
    protocol: serialize to a private tmp file in the target directory,
    ``fsync`` it, ``rename`` over the destination, ``fsync`` the
    directory.  A reader can never observe a half-written checkpoint — it
    sees the old file or the new one.

  * **A write-ahead log** — :class:`WriteAheadLog` is an append-only file
    of stream operations, each framed as a length-prefixed,
    CRC-checksummed record.  Format version 2 carries three record types
    — INSERT (a float32 micro-batch tagged with its start watermark),
    DELETE (an int64 gid batch tagged with the stream watermark at append
    time), EXPIRE (a bare watermark) — while version-1 files (insert-only
    framing) remain fully replayable.  ``insert``/``delete``/``expire``
    append + ``fsync`` the record *before* touching in-memory state, so
    once an operation returns (is *acknowledged*) it is durable.  A crash
    mid-append leaves a torn tail record, which :func:`scan_wal` detects
    (short read or CRC mismatch) and truncates rather than propagating.

  * **Recovery** — :func:`recover` = load the newest valid checkpoint (if
    any) + replay every WAL record past its watermark through the normal
    ``insert``/``delete``/``expire`` paths (with logging suppressed — the
    records are already durable; deletes and expires are idempotent, so
    records the checkpoint already covers are harmless no-ops).  The
    result is a live handle whose ``snapshot()`` is component-identical
    to batch ``dbscan`` on exactly the durable *surviving* points:
    acknowledged operations are never lost, unacknowledged ones are never
    half-applied (an operation is either fully in the WAL or truncated
    with the tail).

Fault injection (tests/test_torch_faults.py) arms :func:`barrier` at named
crash points — the streaming code calls it at every durability barrier and
an armed point terminates the process with ``os._exit`` (the closest
in-process stand-in for ``kill -9``: no atexit, no flushing, no cleanup).
"""
from __future__ import annotations

import io
import json
import os
import struct
import time
import zlib

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# ---------------------------------------------------------------------- #
# fault injection                                                        #
# ---------------------------------------------------------------------- #

# Exit code the injected crashes die with (mirrors SIGKILL's 128 + 9).
FAULT_EXIT_CODE = 137

# Named crash points the streaming code guards with barrier() calls.
FAULT_POINTS = ("pre-insert", "wal-durable", "post-insert", "mid-merge",
                "mid-checkpoint", "mid-wal-append",
                "pre-delete", "wal-durable-delete", "mid-compaction",
                "mid-publish")

_fault_point: str | None = None
_fault_countdown: int = 0


def arm_fault(point: str | None, at: int = 1) -> None:
    """Arm a deterministic crash at the ``at``-th hit of ``point``.

    ``None`` disarms.  Used by the fault-injection harness only; the
    barriers are no-ops when nothing is armed.
    """
    global _fault_point, _fault_countdown
    if point is not None and point not in FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}; "
                         f"one of {FAULT_POINTS}")
    _fault_point = point
    _fault_countdown = int(at)


def barrier(point: str) -> None:
    """Crash-test hook: die (as if kill -9) if ``point`` is armed."""
    global _fault_countdown
    if _fault_point != point:
        return
    _fault_countdown -= 1
    if _fault_countdown <= 0:
        os._exit(FAULT_EXIT_CODE)


def _fault_armed_now(point: str) -> bool:
    """True iff ``point`` is armed and its countdown fires on this hit
    (consumes one hit).  Lets the WAL implement the *torn write* fault,
    which needs custom behaviour (write half a record) rather than an
    immediate exit."""
    global _fault_countdown
    if _fault_point != point:
        return False
    _fault_countdown -= 1
    return _fault_countdown <= 0


# ---------------------------------------------------------------------- #
# errors                                                                 #
# ---------------------------------------------------------------------- #

class CheckpointError(ValueError):
    """A checkpoint file is unreadable: unknown format version, checksum
    mismatch, or a missing/malformed manifest.  Deliberately *not* raised
    for a torn WAL tail — that is expected after a crash and silently
    truncated; a corrupt checkpoint is not (the atomic write protocol
    means one can only arise from external damage)."""


# ---------------------------------------------------------------------- #
# checkpoints                                                            #
# ---------------------------------------------------------------------- #

CHECKPOINT_VERSION = 2

# Array fields serialized per checkpoint, in checksum order.  Version 2
# added the tombstone mask; version-1 files (no tombstones — nothing was
# ever deleted when they were written) still load.
_CKPT_ARRAYS_V1 = ("pts", "counts", "core", "labels")
_CKPT_ARRAYS = _CKPT_ARRAYS_V1 + ("tombstone",)


def _content_checksum(arrays: dict, names=_CKPT_ARRAYS) -> str:
    """CRC-32 over the raw bytes of every array field, in fixed order."""
    crc = 0
    for name in names:
        arr = np.ascontiguousarray(arrays[name])
        crc = zlib.crc32(arr.tobytes(), crc)
        crc = zlib.crc32(repr((name, arr.shape, str(arr.dtype))).encode(),
                         crc)
    return f"{crc:08x}"


def _fsync_dir(path: str) -> None:
    """fsync the directory containing ``path`` so a rename is durable."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:                      # e.g. platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(handle, path: str) -> dict:
    """Atomically serialize a ``StreamingDBSCAN`` handle to ``path``.

    Returns the manifest that was written.  The write is atomic: the
    bytes go to a tmp file in the destination directory, are fsync'd,
    then renamed over ``path`` (and the directory fsync'd), so a crash at
    any barrier leaves either the previous checkpoint or the new one —
    never a torn file.
    """
    arrays = handle._host_arrays()      # numpy copies of the device state
    manifest = {
        "format": "repro-stream-checkpoint",
        "version": CHECKPOINT_VERSION,
        "dtype": "float32",
        "d": int(handle._pts.shape[1]),
        "eps": float(handle.eps),
        "min_pts": int(handle.min_pts),
        "merge_ratio": float(handle._merge_ratio),
        "window": handle.window,
        "buffer_max": int(handle._buffer_max),
        "growth": int(handle._growth),
        "watermark": int(handle.n_points),   # insert-order high-water mark
        "expire_watermark": int(handle._expire_watermark),
        "n_active": int(handle.n_active),
        "n_tombstoned": int(handle.n_tombstoned),
        "n_main": int(handle.n_main),
        "n_inserts": int(handle.n_inserts),
        "n_deletes": int(handle.n_deletes),
        "n_merges": int(handle.n_merges),
        "n_compactions": int(handle.n_compactions),
        "n_repair_sweeps": int(handle.n_repair_sweeps),
        "checksum": _content_checksum(arrays),
    }
    t0 = time.perf_counter()
    buf = io.BytesIO()
    np.savez(buf, manifest=np.frombuffer(
        json.dumps(manifest, sort_keys=True).encode(), np.uint8), **arrays)
    tmp = f"{path}.tmp.{os.getpid()}"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        # os.write may write fewer bytes than asked (Linux caps a single
        # write at ~2GB) — a short write that got fsync'd and renamed
        # would replace the previous good checkpoint with a torn one
        view = memoryview(buf.getvalue())
        while len(view):
            view = view[os.write(fd, view):]
        os.fsync(fd)
    finally:
        os.close(fd)
    barrier("mid-checkpoint")            # tmp durable, rename not yet done
    os.replace(tmp, path)
    _fsync_dir(path)
    obs_metrics.observe("checkpoint_write_seconds",
                        time.perf_counter() - t0)
    obs_metrics.inc("checkpoints_total")
    return manifest


def load_checkpoint(path: str) -> dict:
    """Read + verify a checkpoint; returns ``{manifest, pts, counts, core,
    labels[, tombstone]}`` (``tombstone`` absent for version-1 files).

    Raises :class:`CheckpointError` on an unknown (future) format version,
    a content-checksum mismatch, or a missing/malformed manifest — a
    damaged checkpoint must fail loudly, never silently restore garbage.
    """
    try:
        with np.load(path) as z:
            if "manifest" not in z:
                raise CheckpointError(f"{path}: not a streaming checkpoint "
                                      "(no manifest)")
            try:
                manifest = json.loads(bytes(z["manifest"]).decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise CheckpointError(f"{path}: malformed manifest: {e}")
            version = manifest.get("version")
            if version not in (1, CHECKPOINT_VERSION):
                raise CheckpointError(
                    f"{path}: unsupported checkpoint format version "
                    f"{version!r} (this build reads versions 1 and "
                    f"{CHECKPOINT_VERSION}); refusing to guess")
            names = _CKPT_ARRAYS_V1 if version == 1 else _CKPT_ARRAYS
            arrays = {name: z[name] for name in names}
    except CheckpointError:
        raise
    except zipfile_errors() as e:
        raise CheckpointError(f"{path}: unreadable checkpoint: {e}")
    got = _content_checksum(arrays, names)
    if got != manifest.get("checksum"):
        raise CheckpointError(
            f"{path}: content checksum mismatch (manifest "
            f"{manifest.get('checksum')!r}, computed {got!r}) — "
            "the checkpoint is corrupt")
    if manifest.get("watermark") != len(arrays["pts"]):
        raise CheckpointError(
            f"{path}: watermark {manifest.get('watermark')} does not match "
            f"{len(arrays['pts'])} serialized points")
    return {"manifest": manifest, **arrays}


def zipfile_errors():
    """The exception types a damaged .npz can raise from np.load."""
    import zipfile
    return (OSError, ValueError, zipfile.BadZipFile, KeyError)


# ---------------------------------------------------------------------- #
# write-ahead log                                                        #
# ---------------------------------------------------------------------- #

WAL_VERSION = 2
_WAL_COMPAT = (1, 2)                           # versions scan_wal reads
_WAL_MAGIC = b"RWAL"
_REC_MAGIC = 0x5743_4552                       # "RECW" little-endian
# file header: magic, version, d, eps (f64), min_pts (i32) — shared by
# both format versions, so a version-1 file is identified by its header
_HDR = struct.Struct("<4sHHdi")
# v1 record header: magic, start watermark, point count, crc32
_REC = struct.Struct("<IQII")
# v2 record header: magic, record type, argument, payload count, crc32
_REC2 = struct.Struct("<IBQII")

# v2 record types.  INSERT: arg = start watermark, payload = (k, d)
# float32 batch.  DELETE: arg = stream watermark (n_points) at append
# time (used as the replay gap check), payload = k int64 gids.  EXPIRE:
# arg = expiry watermark, no payload.
REC_INSERT, REC_DELETE, REC_EXPIRE = 1, 2, 3


class WALError(ValueError):
    """A WAL file exists but its *header* is incompatible (wrong magic on
    a non-empty file, future version, parameter mismatch with the
    handle), or an append is illegal for its format version (delete
    records into a version-1 log).  Torn/corrupt tail *records* never
    raise — they are truncated, which is the whole point of the log."""


def _record_crc(start_gid: int, k: int, payload: bytes) -> int:
    """v1 insert-record checksum."""
    return zlib.crc32(struct.pack("<QI", start_gid, k) + payload)


def _record_crc2(rtype: int, arg: int, k: int, payload: bytes) -> int:
    """v2 typed-record checksum (covers the type tag too)."""
    return zlib.crc32(struct.pack("<BQI", rtype, arg, k) + payload)


def _payload_nbytes(rtype: int, k: int, d: int) -> int:
    if rtype == REC_INSERT:
        return k * d * 4                 # (k, d) float32
    if rtype == REC_DELETE:
        return k * 8                     # k int64 gids
    return 0                             # EXPIRE carries no payload


def scan_wal(path: str):
    """Parse a WAL file (either format version), tolerating a torn tail.

    Returns ``(header, ops, valid_end)`` where ``header`` is a dict
    (``None`` for a missing/empty file), ``ops`` is a list of operation
    tuples in append order —

      * ``("insert", start_gid, (k, d) float32 batch)``
      * ``("delete", watermark, (k,) int64 gids)``
      * ``("expire", watermark, None)``

    (version-1 files only ever yield inserts) — and ``valid_end`` is the
    byte offset of the last fully-valid record; everything past it (a
    torn or checksum-corrupt tail) should be truncated before appending
    again.  A torn *header* (crash during the very first append) yields
    ``(None, [], 0)``.

    Raises :class:`WALError` only for a structurally incompatible header
    (bad magic on a non-empty file, future version) — i.e. "this is not
    our log", which replaying could not make right.
    """
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return None, [], 0
    if len(blob) < _HDR.size:
        return None, [], 0               # torn header: nothing durable yet
    magic, version, d, eps, min_pts = _HDR.unpack_from(blob, 0)
    if magic != _WAL_MAGIC:
        raise WALError(f"{path}: not a streaming WAL (bad magic)")
    if version not in _WAL_COMPAT:
        raise WALError(f"{path}: unsupported WAL version {version} "
                       f"(this build reads {_WAL_COMPAT})")
    header = {"version": version, "d": d, "eps": eps, "min_pts": min_pts}
    ops = []
    off = _HDR.size
    valid_end = off
    if version == 1:
        while off + _REC.size <= len(blob):
            rmagic, start_gid, k, crc = _REC.unpack_from(blob, off)
            if rmagic != _REC_MAGIC:
                break                    # corrupt tail: stop, truncate here
            body_end = off + _REC.size + k * d * 4
            if body_end > len(blob):
                break                    # torn payload
            payload = blob[off + _REC.size:body_end]
            if _record_crc(start_gid, k, payload) != crc:
                break                    # bit-damaged tail record
            ops.append(("insert", int(start_gid),
                        np.frombuffer(payload, np.float32).reshape(k, d)))
            off = valid_end = body_end
        return header, ops, valid_end
    while off + _REC2.size <= len(blob):
        rmagic, rtype, arg, k, crc = _REC2.unpack_from(blob, off)
        if rmagic != _REC_MAGIC or rtype not in (REC_INSERT, REC_DELETE,
                                                 REC_EXPIRE):
            break                        # corrupt tail: stop, truncate here
        body_end = off + _REC2.size + _payload_nbytes(rtype, k, d)
        if body_end > len(blob):
            break                        # torn payload
        payload = blob[off + _REC2.size:body_end]
        if _record_crc2(rtype, arg, k, payload) != crc:
            break                        # bit-damaged tail record
        if rtype == REC_INSERT:
            ops.append(("insert", int(arg),
                        np.frombuffer(payload, np.float32).reshape(k, d)))
        elif rtype == REC_DELETE:
            ops.append(("delete", int(arg),
                        np.frombuffer(payload, "<i8").astype(np.int64)))
        else:
            ops.append(("expire", int(arg), None))
        off = valid_end = body_end
    return header, ops, valid_end


class WriteAheadLog:
    """Append-only durable log of stream operations.

    Opened lazily: the file (and its parameter header) is created on the
    first append, so a cold-start handle can attach a WAL before its
    dimensionality is known.  New files are created at format version 2;
    reopening an existing log validates the header against the handle's
    parameters, keeps the file's own version for further appends, and
    truncates any torn tail left by a previous crash.  Version-1 files
    accept further *insert* appends (their only framing) — delete/expire
    appends raise :class:`WALError` until a checkpoint :meth:`reset`
    rewrites the file at the current version.
    """

    def __init__(self, path: str, *, eps: float, min_pts: int):
        self.path = str(path)
        self.eps = float(eps)
        self.min_pts = int(min_pts)
        self._f = None                   # opened on first append/reopen
        self._d: int | None = None
        self._version: int | None = None

    def _open_for_append(self, d: int) -> None:
        header, _, valid_end = scan_wal(self.path)
        if header is not None:
            if header["d"] != d:
                raise WALError(
                    f"{self.path}: WAL is {header['d']}-d, handle is {d}-d")
            if (header["eps"] != self.eps
                    or header["min_pts"] != self.min_pts):
                raise WALError(
                    f"{self.path}: WAL parameters (eps={header['eps']}, "
                    f"min_pts={header['min_pts']}) do not match the handle "
                    f"(eps={self.eps}, min_pts={self.min_pts})")
            self._f = open(self.path, "r+b")
            self._f.truncate(valid_end)  # drop any torn tail
            self._f.seek(valid_end)
            self._version = header["version"]
        else:
            self._f = open(self.path, "wb")
            self._f.write(_HDR.pack(_WAL_MAGIC, WAL_VERSION, d,
                                    self.eps, self.min_pts))
            self._version = WAL_VERSION
        self._d = d

    def _write_record(self, rec: bytes) -> None:
        if _fault_armed_now("mid-wal-append"):
            # torn-write fault: half the record reaches the disk, then the
            # process dies without any cleanup
            self._f.write(rec[:max(1, len(rec) // 2)])
            self._f.flush()
            os.fsync(self._f.fileno())
            os._exit(FAULT_EXIT_CODE)
        self._f.write(rec)
        self._f.flush()
        t0 = time.perf_counter()
        os.fsync(self._f.fileno())
        obs_metrics.observe("wal_fsync_seconds", time.perf_counter() - t0)
        obs_metrics.inc("wal_appends_total")

    def append(self, batch: np.ndarray, start_gid: int) -> None:
        """Durably append one insert batch (fsync before returning)."""
        batch = np.ascontiguousarray(batch, np.float32)
        k, d = batch.shape
        if self._f is None:
            self._open_for_append(d)
        payload = batch.tobytes()
        if self._version == 1:           # keep the file's own framing
            rec = _REC.pack(_REC_MAGIC, start_gid, k,
                            _record_crc(start_gid, k, payload)) + payload
        else:
            rec = _REC2.pack(
                _REC_MAGIC, REC_INSERT, start_gid, k,
                _record_crc2(REC_INSERT, start_gid, k, payload)) + payload
        self._write_record(rec)

    def append_delete(self, gids: np.ndarray, watermark: int,
                      *, d: int) -> None:
        """Durably append one delete batch (``watermark`` = the handle's
        ``n_points`` at append time, the replay gap check)."""
        if self._f is None:
            self._open_for_append(d)
        if self._version == 1:
            raise WALError(
                f"{self.path}: version-1 WAL has no delete framing — "
                "checkpoint the handle (which resets the log at the "
                "current version) before deleting, or start a fresh log")
        gids = np.ascontiguousarray(gids, "<i8")
        payload = gids.tobytes()
        k = len(gids)
        rec = _REC2.pack(
            _REC_MAGIC, REC_DELETE, watermark, k,
            _record_crc2(REC_DELETE, watermark, k, payload)) + payload
        self._write_record(rec)

    def append_expire(self, watermark: int, *, d: int) -> None:
        """Durably append one expiry watermark record."""
        if self._f is None:
            self._open_for_append(d)
        if self._version == 1:
            raise WALError(
                f"{self.path}: version-1 WAL has no expire framing — "
                "checkpoint the handle (which resets the log at the "
                "current version) before expiring, or start a fresh log")
        rec = _REC2.pack(_REC_MAGIC, REC_EXPIRE, watermark, 0,
                         _record_crc2(REC_EXPIRE, watermark, 0, b""))
        self._write_record(rec)

    def reset(self, _watermark: int | None = None) -> None:
        """Truncate the log and rewrite its header at the current format
        version — called after a successful checkpoint (whose watermark
        covers every logged record; this is also how a version-1 file
        upgrades to the delete-capable framing).  Safe against a crash at
        any point: until the rewrite completes, recovery simply skips
        records below the checkpoint watermark."""
        if self._f is None:
            header, _, _ = scan_wal(self.path)
            if header is None:
                return
            self._open_for_append(header["d"])
        self._f.truncate(0)
        self._f.seek(0)
        self._f.write(_HDR.pack(_WAL_MAGIC, WAL_VERSION, self._d,
                                self.eps, self.min_pts))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._version = WAL_VERSION

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------- #
# recovery                                                               #
# ---------------------------------------------------------------------- #

# Handle options recover() forwards to a freshly-built instance.
_HANDLE_KWARGS = ("merge_ratio", "window", "buffer_max", "growth")


def recover(checkpoint_path: str | None = None, wal_path: str | None = None,
            *, device=None, **handle_kwargs):
    """Rebuild a live ``StreamingDBSCAN`` from durable state.

    Load the checkpoint (if the file exists), then replay every WAL
    record through the normal operation paths — insert records fully
    below the checkpoint's watermark are already folded in and are
    skipped; deletes and expires are idempotent, so replaying ones the
    checkpoint covers is a no-op; a torn/corrupt tail is truncated
    silently (those operations were never acknowledged).  With no
    checkpoint, replay starts from an empty handle using the parameters
    stored in the WAL header.  The recovered handle re-attaches the same
    WAL and checkpoint paths, so serving (and further crash/recovery
    cycles) continue seamlessly.

    ``device`` is where the recovered handle lives (resolved by
    ``repro_torch.core.dispatch.resolve_device``: default the current CUDA
    device).

    Raises:
        CheckpointError: the checkpoint file exists but is damaged or has
            an unknown format version.
        WALError: the WAL header is structurally incompatible, its
            parameters disagree with the checkpoint manifest, or the log
            has a *gap* — a record that references stream state past the
            recovered watermark, meaning acknowledged records depend on a
            prefix that is missing (never silently dropped).
        ValueError: neither a checkpoint nor a non-empty WAL exists (there
            is nothing to recover and no parameters to start from).
    """
    from repro_torch.stream.index import StreamingDBSCAN

    state = None
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state = load_checkpoint(checkpoint_path)
    wal_header, ops, _ = (scan_wal(wal_path) if wal_path is not None
                          else (None, [], 0))
    if state is None and wal_header is None:
        raise ValueError(
            "nothing to recover: no checkpoint file and no (non-empty) WAL "
            f"(checkpoint={checkpoint_path!r}, wal={wal_path!r})")
    if state is not None and wal_header is not None:
        m = state["manifest"]
        if (wal_header["d"] != m["d"] or wal_header["eps"] != m["eps"]
                or wal_header["min_pts"] != m["min_pts"]):
            raise WALError(
                f"{wal_path}: WAL header (d={wal_header['d']}, "
                f"eps={wal_header['eps']}, min_pts={wal_header['min_pts']}) "
                f"does not match the checkpoint manifest (d={m['d']}, "
                f"eps={m['eps']}, min_pts={m['min_pts']}) — the files are "
                "from different parameter runs; replaying would corrupt "
                "the index")

    if state is not None:
        m = state["manifest"]
        eps, min_pts = m["eps"], m["min_pts"]
        opts = {"merge_ratio": m.get("merge_ratio"),
                "window": m.get("window"),
                "buffer_max": m.get("buffer_max"),
                "growth": m.get("growth")}
        opts = {k: v for k, v in opts.items() if v is not None}
        opts.update({k: v for k, v in handle_kwargs.items()
                     if k in _HANDLE_KWARGS and v is not None})
        h = StreamingDBSCAN(None, eps, min_pts, device=device, **opts)
        h._adopt_state(state)
    else:
        eps, min_pts = wal_header["eps"], wal_header["min_pts"]
        h = StreamingDBSCAN(None, eps, min_pts, device=device, **{
            k: v for k, v in handle_kwargs.items() if k in _HANDLE_KWARGS})

    with obs_trace.span("stream.replay", n_ops=len(ops)):
        _replay(h, ops, wal_path)
    obs_metrics.inc("wal_replayed_ops_total", float(len(ops)))

    # re-attach durability so the recovered handle keeps serving durably
    if wal_path is not None:
        h._wal = WriteAheadLog(wal_path, eps=h.eps, min_pts=h.min_pts)
    if checkpoint_path is not None:
        h._ckpt_path = checkpoint_path
    for k, v in handle_kwargs.items():
        if k == "checkpoint_every":
            h._ckpt_every = int(v)
    return h


def _replay(h, ops, wal_path) -> None:
    """Apply scanned WAL ops to a recovered handle in append order (the
    body of :func:`recover`'s replay phase)."""
    for op in ops:
        kind, arg, data = op
        if kind == "insert":
            if arg + len(data) <= h.n_points:
                continue                 # already covered by the checkpoint
            if arg != h.n_points:
                # A gap means acknowledged records depend on state we do
                # not have (e.g. the WAL was truncated against a
                # checkpoint that is not the one being restored, or the
                # checkpoint file was swapped for an older/foreign one).
                # Applying out of order would silently violate the
                # durability contract — fail loud.
                raise WALError(
                    f"{wal_path}: WAL insert record starts at watermark "
                    f"{arg} but the recovered state ends at {h.n_points} — "
                    "the log's prefix is missing; refusing to replay a "
                    "gapped log (acknowledged data would be silently lost)")
            h.insert(data)               # _wal is None here: no re-logging
        elif kind == "delete":
            if arg > h.n_points or (len(data)
                                    and int(data.max()) >= h.n_points):
                raise WALError(
                    f"{wal_path}: WAL delete record references stream "
                    f"watermark {max(int(arg), int(data.max()) + 1 if len(data) else 0)} "
                    f"but the recovered state ends at {h.n_points} — the "
                    "log's prefix is missing; refusing to replay a gapped "
                    "log")
            h.delete(data)               # idempotent: dead gids are skipped
        else:                            # expire
            if arg > h.n_points:
                raise WALError(
                    f"{wal_path}: WAL expire record has watermark {arg} "
                    f"but the recovered state ends at {h.n_points} — the "
                    "log's prefix is missing; refusing to replay a gapped "
                    "log")
            h.expire(arg)                # idempotent
