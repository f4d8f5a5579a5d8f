"""Per-index write-ahead log: acknowledged writes survive the process.

Copy of ``repro.checkpoint.wal`` with byte-identical framing: a log written
by either package reads back record for record in the other.

The mutable indexes acknowledge ``insert``/``delete`` from an in-memory
write buffer; checkpoints seal that state only when ``save()`` runs.
The WAL closes the gap: every mutation appends one framed record *before*
the in-memory state changes, so a crash at any instant loses nothing
that was acknowledged — ``load()`` replays the tail on top of the last
checkpoint, and the sequential :class:`~repro_torch.index.mutable.LsmIdSpace`
id assignment makes the replay id-exact (recovery is bit-equal to never
having crashed).

Record framing
--------------
The file opens with an 8-byte magic, then repeated frames::

    [u32 payload_len][u32 crc32(payload)][u64 seq][payload]

``payload`` is ``[u32 header_len][json header][array bytes...]`` where
the JSON header carries the op name, a small metadata dict (the
``next_id`` watermark used for replay dedup) and the name/shape/dtype of
each array, in order.  The CRC covers the sequence number and the whole
payload (a corrupted length field changes what the CRC is computed
over), so any single bit flip anywhere in a frame — or a torn tail from
a mid-write power cut — is detected and the log is truncated at the
last intact frame.

Group commit
------------
``append`` acknowledges after ``write()`` returns: the record is in the
OS page cache, which survives a *process* crash (SIGKILL) uncondition-
ally.  ``fsync`` — the power-loss barrier — is batched by
:class:`WalConfig`: every ``sync_every`` records or ``sync_interval_ms``
milliseconds, whichever comes first; ``sync_every=1`` degenerates to
fsync-per-record full durability.  The default trades a bounded
power-loss window (not process-crash window) for a cheaper append path
than one fsync per record.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.testing.faults import fault_point

__all__ = [
    "WalConfig", "WalError", "WalWriteError", "WalRecord",
    "WriteAheadLog", "read_records", "open_and_recover", "wal_path",
]

_MAGIC = b"RWAL0001"
_FRAME = struct.Struct("<IIQ")          # payload_len, crc32, seq
_MAX_PAYLOAD = 1 << 30                  # sanity bound when scanning


def _crc(seq: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(struct.pack("<Q", seq)))


class WalError(IOError):
    """Structural WAL problem (bad magic, misuse)."""


class WalWriteError(WalError):
    """An append/fsync failed — the mutation was NOT applied.

    The engine treats this as the signal to enter degraded read-only
    mode: without a working log, acknowledging writes would reintroduce
    the silent-loss window the WAL exists to close.
    """


@dataclasses.dataclass(frozen=True)
class WalConfig:
    """Group-commit policy.

    ``sync_every``: fsync after this many unsynced records (1 = every
    record).  ``sync_interval_ms``: also fsync when the oldest unsynced
    record is older than this, so a quiet stream still bounds its
    power-loss window.
    """
    sync_every: int = 32
    sync_interval_ms: float = 50.0


@dataclasses.dataclass(frozen=True)
class WalRecord:
    seq: int
    op: str
    arrays: Dict[str, np.ndarray]
    meta: Dict[str, Any]


def wal_path(ckpt_path: str) -> str:
    """Where the WAL for an index checkpointed at ``ckpt_path`` lives."""
    return os.path.join(ckpt_path, "wal.log")


def _encode(op: str, arrays: Dict[str, np.ndarray],
            meta: Dict[str, Any]) -> bytes:
    bufs = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    header = {
        "op": op,
        "meta": meta,
        "arrays": [[k, list(v.shape), str(v.dtype)] for k, v in bufs.items()],
    }
    hb = json.dumps(header).encode()
    parts = [struct.pack("<I", len(hb)), hb]
    parts.extend(v.tobytes() for v in bufs.values())
    return b"".join(parts)


def _decode(payload: bytes) -> Tuple[str, Dict[str, np.ndarray], Dict]:
    (hlen,) = struct.unpack_from("<I", payload, 0)
    header = json.loads(payload[4:4 + hlen].decode())
    arrays: Dict[str, np.ndarray] = {}
    off = 4 + hlen
    for name, shape, dtype in header["arrays"]:
        dt = np.dtype(dtype)
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        arrays[name] = np.frombuffer(
            payload[off:off + nbytes], dtype=dt
        ).reshape(shape).copy()
        off += nbytes
    return header["op"], arrays, header.get("meta", {})


class WriteAheadLog:
    """Append-only framed log with batched fsync (see module docstring)."""

    def __init__(self, path: str, config: Optional[WalConfig] = None,
                 *, _start_seq: int = 0, _expect_empty: bool = True):
        self.path = path
        self.config = config or WalConfig()
        existed = os.path.exists(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            size = os.fstat(self._fd).st_size
            if size == 0:
                os.write(self._fd, _MAGIC)
                os.fsync(self._fd)
                if not existed:
                    _dir_fsync(os.path.dirname(os.path.abspath(path)))
            elif _expect_empty and size > len(_MAGIC):
                raise WalError(
                    f"{path} already holds records; load() the index (which "
                    "replays and re-attaches) instead of enable_wal()"
                )
        except Exception:
            os.close(self._fd)
            raise
        self._seq = _start_seq
        self._unsynced = 0
        self._oldest_unsynced_t: Optional[float] = None
        self._closed = False

    # -- write path --------------------------------------------------------
    def append(self, op: str, arrays: Dict[str, np.ndarray],
               meta: Dict[str, Any]) -> int:
        """Frame + write one record; group-commit fsync.  Returns its seq.

        On any OS error the log is poisoned for the caller via
        :class:`WalWriteError`; the record may or may not be on disk, but
        the caller has not mutated state yet (log-then-apply), so either
        outcome is consistent: replay of a record whose apply never
        happened is exactly a replay of the crash case.
        """
        if self._closed:
            raise WalWriteError(f"{self.path}: WAL is closed")
        payload = _encode(op, arrays, meta)
        seq = self._seq
        frame = _FRAME.pack(len(payload), _crc(seq, payload), seq) + payload
        try:
            fault_point("wal.append.pre_write", path=self.path)
            os.write(self._fd, frame)
            fault_point("wal.append.post_write", path=self.path)
        except OSError as e:
            raise WalWriteError(f"{self.path}: append failed: {e}") from e
        self._seq = seq + 1
        self._unsynced += 1
        now = time.monotonic()
        if self._oldest_unsynced_t is None:
            self._oldest_unsynced_t = now
        cfg = self.config
        if (self._unsynced >= max(1, cfg.sync_every)
                or (now - self._oldest_unsynced_t) * 1e3
                >= cfg.sync_interval_ms):
            self.sync()
        return seq

    def sync(self) -> None:
        """Force the power-loss barrier for everything appended so far."""
        if self._closed or self._unsynced == 0:
            return
        try:
            fault_point("wal.fsync.pre", path=self.path)
            os.fsync(self._fd)
        except OSError as e:
            raise WalWriteError(f"{self.path}: fsync failed: {e}") from e
        self._unsynced = 0
        self._oldest_unsynced_t = None

    def truncate(self) -> None:
        """Drop every record: the checkpoint that just committed covers them.

        Called by ``save()`` *after* its manifest commit; a crash between
        the commit and this truncate only means records replay on top of
        state that already contains them — the ``next_id`` watermark in
        each record makes that replay a no-op.
        """
        if self._closed:
            return
        fault_point("wal.truncate.pre", path=self.path)
        os.ftruncate(self._fd, len(_MAGIC))
        os.fsync(self._fd)
        fault_point("wal.truncate.post", path=self.path)
        self._unsynced = 0
        self._oldest_unsynced_t = None

    def close(self) -> None:
        if self._closed:
            return
        try:
            if self._unsynced:
                os.fsync(self._fd)
        except OSError:
            pass
        os.close(self._fd)
        self._closed = True

    @property
    def next_seq(self) -> int:
        return self._seq

    def __repr__(self) -> str:
        return (f"WriteAheadLog({self.path!r}, next_seq={self._seq}, "
                f"sync_every={self.config.sync_every})")


def _dir_fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_records(path: str) -> Tuple[List[WalRecord], int, bool]:
    """Scan a WAL file.  Returns ``(records, good_end_offset, torn)``.

    Scanning stops at the first frame whose length field runs past EOF
    or whose CRC fails — a torn tail from a crash mid-write, or a bit
    flip.  Everything before it is intact (each frame is independently
    CRC-framed); everything from it on is discarded by recovery.
    """
    records: List[WalRecord] = []
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(_MAGIC)] != _MAGIC:
        raise WalError(f"{path}: bad WAL magic")
    off = len(_MAGIC)
    torn = False
    while off < len(blob):
        if off + _FRAME.size > len(blob):
            torn = True
            break
        plen, crc, seq = _FRAME.unpack_from(blob, off)
        start = off + _FRAME.size
        if plen > _MAX_PAYLOAD or start + plen > len(blob):
            torn = True
            break
        payload = blob[start:start + plen]
        if _crc(seq, payload) != crc:
            torn = True
            break
        try:
            op, arrays, meta = _decode(payload)
        except Exception:
            torn = True
            break
        records.append(WalRecord(seq=seq, op=op, arrays=arrays, meta=meta))
        off = start + plen
    return records, off, torn


def open_and_recover(
    path: str, config: Optional[WalConfig] = None
) -> Tuple[List[WalRecord], "WriteAheadLog"]:
    """Read the intact prefix, truncate any torn tail, re-open for append.

    The returned log continues the sequence numbering after the last
    intact record, so replay-then-keep-serving needs no special casing.
    """
    records, good_end, torn = read_records(path)
    if torn:
        fd = os.open(path, os.O_WRONLY)
        try:
            os.ftruncate(fd, good_end)
            os.fsync(fd)
        finally:
            os.close(fd)
    start_seq = records[-1].seq + 1 if records else 0
    wal = WriteAheadLog(path, config, _start_seq=start_seq,
                        _expect_empty=False)
    return records, wal
