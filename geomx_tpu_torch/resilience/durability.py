"""Durable host-plane state: atomic snapshots + an append-only journal
(port of geomx_tpu/resilience/durability.py, which imports no jax).

The host plane's central processes — ``GeoPSServer`` (the parameter
store, merge rounds, per-sender round counts) and ``GeoScheduler``
(roster, id table, epoch) — hold everything in memory, so one process
death would lose the run.  :class:`DurableStateStore` is the shared
persistence primitive both stand on:

- a **snapshot** file written atomically with the same temp-file +
  ``os.replace`` pattern ``utils/checkpoint.save_checkpoint`` and the
  profiler dumps use — a crash mid-write never corrupts the previous
  snapshot;
- an **append-only journal** of incremental records (one per completed
  merge round / roster mutation), each length-prefixed and CRC32-framed
  so a crash mid-append leaves a *detectably* torn tail that replay
  truncates instead of mis-parsing;
- a persisted **generation counter** bumped once per process start —
  the restart token every server/scheduler reply carries so clients
  *detect* a restart and run the session-resume handshake.

Recovery contract: ``load()`` returns the last snapshot plus every
journal record appended after it (in order); the owner replays the
records over the snapshot to reach its exact pre-crash durable state.
Records carry a monotone sequence number; ``compact()`` folds the
journal into a fresh snapshot and truncates, and replay skips records
the snapshot already covers — so a crash at any point of the compaction
never double-applies or loses a record.

Values are host objects (numpy arrays, primitives).  Device trees go
through ``utils/checkpoint.tree_to_bytes`` *at the owner* (the server
serializes optimizer-state trees that way), keeping this module free of
torch: the file format is the JAX package's byte for byte (magic,
``<II`` record head, CRC32, pickle protocol 4), so a store of
primitives and numpy arrays written by either package loads in the
other.  Optimizer-state blobs inside a server's records are each
package's own tree format and do not cross.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import threading
import zlib
from typing import Any, List, Optional, Tuple

_REC_HEAD = struct.Struct("<II")   # payload length, crc32(payload)
_SNAP_MAGIC = b"GXSNAP1\n"
_JOURNAL_MAGIC = b"GXJRNL1\n"


class DurabilityError(RuntimeError):
    """A durable file exists but cannot be read as written (wrong magic,
    corrupt snapshot body).  A *torn journal tail* is NOT an error — it
    is the expected shape of a crash mid-append and is truncated."""


def _atomic_write(path: str, data: bytes) -> None:
    # the shared atomic-replace owner (utils/atomicio.py) with
    # fsync=True: data fsynced before the rename, the DIRECTORY fsynced
    # after it — compact() truncates the journal right after the
    # snapshot replace, and without the directory fsync a power loss
    # could persist the truncation but not the rename, losing every
    # record since the previous snapshot
    from geomx_tpu_torch.utils.atomicio import atomic_write_bytes
    atomic_write_bytes(path, data, fsync=True)


class DurableStateStore:
    """One named durable state: ``<dir>/<name>.snap`` + ``.journal`` +
    ``.gen``.  Thread-safe; every mutation is crash-safe in the sense
    above.  ``name`` must be unique per logical node within the
    directory (the server uses its rank, the scheduler ``scheduler``).
    """

    def __init__(self, directory: str, name: str,
                 fsync_journal: bool = True):
        self.directory = str(directory)
        self.name = str(name)
        os.makedirs(self.directory, exist_ok=True)
        # a SIGKILL between mkstemp and the rename leaves a uniquely
        # named orphan temp; the restart (this constructor) is the one
        # place that can reclaim it without racing a live writer
        from geomx_tpu_torch.utils.atomicio import sweep_stale_tmp
        sweep_stale_tmp(self.directory)
        self._snap_path = os.path.join(self.directory, name + ".snap")
        self._journal_path = os.path.join(self.directory, name + ".journal")
        self._gen_path = os.path.join(self.directory, name + ".gen")
        self._lock = threading.Lock()
        self._fsync = bool(fsync_journal)
        self._journal_f = None
        self._seq = 0            # last sequence number written
        self._snap_seq = 0       # sequence the snapshot covers through
        self.records_appended = 0

    # ---- generation token --------------------------------------------------

    def bump_generation(self) -> int:
        """Read-increment-persist the generation counter (atomic via the
        snapshot write pattern).  Call once per process start; the
        result is the restart token replies carry."""
        with self._lock:
            gen = self._read_generation_locked() + 1
            _atomic_write(self._gen_path, str(gen).encode("ascii"))
            return gen

    def generation(self) -> int:
        with self._lock:
            return self._read_generation_locked()

    def _read_generation_locked(self) -> int:
        try:
            with open(self._gen_path, "rb") as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return 0
        except ValueError as e:
            raise DurabilityError(
                f"unreadable generation file {self._gen_path}: {e}") from e

    # ---- snapshot ----------------------------------------------------------

    def snapshot(self, state: Any) -> None:
        """Atomically persist ``state`` as the new snapshot.  Does NOT
        touch the journal — use :meth:`compact` to fold and truncate."""
        with self._lock:
            self._snapshot_locked(state)

    def _snapshot_locked(self, state: Any) -> None:
        payload = pickle.dumps({"seq": self._seq, "state": state},
                               protocol=4)
        _atomic_write(self._snap_path,
                      _SNAP_MAGIC + _REC_HEAD.pack(
                          len(payload), zlib.crc32(payload)) + payload)
        self._snap_seq = self._seq

    def compact(self, state: Any) -> None:
        """Snapshot ``state`` then truncate the journal.  Crash-safe in
        both orders: snapshot-then-crash leaves old journal records with
        seq <= the snapshot's, which replay skips; a crash before the
        snapshot leaves everything as it was."""
        with self._lock:
            self._snapshot_locked(state)
            if self._journal_f is not None:
                try:
                    self._journal_f.close()
                except OSError:
                    pass
                self._journal_f = None
            _atomic_write(self._journal_path, _JOURNAL_MAGIC)

    # ---- journal -----------------------------------------------------------

    def append(self, record: Any) -> int:
        """Append one journal record; returns its sequence number.  The
        frame is ``[len][crc32][pickle]`` so a torn tail (crash mid-
        write) is detected and truncated on replay, never mis-parsed."""
        with self._lock:
            self._seq += 1
            payload = pickle.dumps({"seq": self._seq, "rec": record},
                                   protocol=4)
            f = self._journal_handle_locked()
            f.write(_REC_HEAD.pack(len(payload), zlib.crc32(payload)))
            f.write(payload)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
            self.records_appended += 1
            return self._seq

    def _journal_handle_locked(self):
        if self._journal_f is None:
            fresh = not os.path.exists(self._journal_path)
            self._journal_f = open(self._journal_path, "ab")
            if fresh or os.path.getsize(self._journal_path) == 0:
                self._journal_f.write(_JOURNAL_MAGIC)
                self._journal_f.flush()
        return self._journal_f

    # ---- recovery ----------------------------------------------------------

    def load(self) -> Tuple[Optional[Any], List[Any]]:
        """``(snapshot_state | None, [records after the snapshot])``.
        Replaying the records over the snapshot reconstructs the exact
        pre-crash durable state.  Also primes the internal sequence
        counter so appends after a restart continue the numbering, and
        PHYSICALLY truncates a torn tail — otherwise post-restart
        appends would land *behind* the torn bytes and a second crash
        would silently lose every record since the first restart."""
        with self._lock:
            snap_state, snap_seq = self._load_snapshot_locked()
            records, last_seq, valid_end = \
                self._load_journal_locked(snap_seq)
            self._seq = max(snap_seq, last_seq)
            self._snap_seq = snap_seq
            if valid_end is not None:
                if self._journal_f is not None:
                    try:
                        self._journal_f.close()
                    except OSError:
                        pass
                    self._journal_f = None
                with open(self._journal_path, "r+b") as f:
                    f.truncate(valid_end)
            return snap_state, records

    def _load_snapshot_locked(self) -> Tuple[Optional[Any], int]:
        try:
            with open(self._snap_path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None, 0
        if not blob.startswith(_SNAP_MAGIC):
            raise DurabilityError(
                f"{self._snap_path}: bad snapshot magic")
        body = blob[len(_SNAP_MAGIC):]
        if len(body) < _REC_HEAD.size:
            raise DurabilityError(f"{self._snap_path}: truncated header")
        n, crc = _REC_HEAD.unpack_from(body, 0)
        payload = body[_REC_HEAD.size:_REC_HEAD.size + n]
        # the snapshot was written atomically, so corruption here is
        # disk damage, not a crash artifact — refuse to guess
        if len(payload) != n or zlib.crc32(payload) != crc:
            raise DurabilityError(
                f"{self._snap_path}: snapshot payload fails its CRC")
        doc = pickle.loads(payload)
        return doc["state"], int(doc["seq"])

    def _load_journal_locked(self, min_seq: int
                             ) -> Tuple[List[Any], int, Optional[int]]:
        """Returns ``(records, last_seq, torn_truncate_at)`` where the
        third element is the byte offset of the last VALID record's end
        when torn bytes follow it (None for a clean file)."""
        try:
            with open(self._journal_path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return [], min_seq, None
        if not blob:
            return [], min_seq, None  # crashed between create and magic
        if not blob.startswith(_JOURNAL_MAGIC):
            raise DurabilityError(
                f"{self._journal_path}: bad journal magic")
        buf = io.BytesIO(blob[len(_JOURNAL_MAGIC):])
        records: List[Any] = []
        last_seq = min_seq
        valid_end = len(_JOURNAL_MAGIC)
        while True:
            head = buf.read(_REC_HEAD.size)
            if len(head) < _REC_HEAD.size:
                break  # clean EOF or torn length header: stop
            n, crc = _REC_HEAD.unpack(head)
            payload = buf.read(n)
            if len(payload) != n or zlib.crc32(payload) != crc:
                break  # torn tail (crash mid-append): truncate here
            valid_end = len(_JOURNAL_MAGIC) + buf.tell()
            doc = pickle.loads(payload)
            seq = int(doc["seq"])
            if seq <= min_seq:
                continue  # the snapshot already covers this record
            records.append(doc["rec"])
            last_seq = max(last_seq, seq)
        torn = valid_end if valid_end < len(blob) else None
        return records, last_seq, torn

    # ---- introspection / teardown ------------------------------------------

    def journal_bytes(self) -> int:
        try:
            return os.path.getsize(self._journal_path)
        except OSError:
            return 0

    def snapshot_bytes(self) -> int:
        try:
            return os.path.getsize(self._snap_path)
        except OSError:
            return 0

    def close(self) -> None:
        with self._lock:
            if self._journal_f is not None:
                try:
                    self._journal_f.close()
                except OSError:
                    pass
                self._journal_f = None


def durable_dir_from_env(explicit: Optional[str] = None) -> Optional[str]:
    """The one resolution point for ``GEOMX_DURABLE_DIR``: an explicit
    argument wins, the env var is the deployment default, and None/""
    means the node runs memory-only."""
    if explicit is not None:
        return explicit or None
    # graftlint: disable=GXL006 — host-plane knob
    return os.environ.get("GEOMX_DURABLE_DIR") or None


def record_host_restart(node: str, generation: int,
                        kind: Optional[str] = None, **detail) -> None:
    """A host-plane process restored from its durable store with a
    generation above 1 is a restart: announce it through
    ``telemetry.flight.announce_host_restart`` — bump
    ``geomx_host_restarts_total{node}``, set
    ``geomx_host_generation{node}`` and fan the incident (``kind``:
    ``scheduler_restart`` for the scheduler, else ``server_restart``)
    out to the event log and every installed flight recorder.
    Best-effort: reporting a failure never compounds it."""
    if kind is None:
        kind = "scheduler_restart" if node == "scheduler" \
            else "server_restart"
    try:
        from geomx_tpu_torch.telemetry.flight import announce_host_restart
        announce_host_restart(node, generation, kind, **detail)
    except Exception:
        pass
