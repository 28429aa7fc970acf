"""Host-side record journal (pipelinedp_tpu/runtime/journal.py).

The multi-tenant service persists each tenant's ledger trail here (key
``__odometer__``, runtime/observability.persist_odometer). The on-disk
format is the JAX package's, byte for byte in layout: one ``.npz`` a
record, named ``<job>__<key>.npz``, holding ``ids``, ``out__<column>``
arrays and a ``__crc32__`` checksum over the payload's names, dtypes,
shapes and bytes. A ledger directory either package wrote reloads in the
other.

Integrity: get() verifies the checksum; a record that fails (truncated,
bit-flipped, missing its checksum) is quarantined (renamed to
``<record>.npz.corrupt``), never replayed, and counted in
``journal_quarantined``. put() writes a temporary file, fsyncs it and
renames it into place; a failed write or fsync unlinks the temporary
file and is rewritten once on a fresh descriptor, and a persist that
stays sick (or ENOSPC) raises StorageUnavailableError, the previous
record remaining the durable truth. Construction sweeps ``*.tmp`` files a
crashed writer left.

Not ported yet (ROADMAP item 13): the block-record side of the blocked
drivers (resume, compact(), process scoping and adopt_job) and the fault
seams of faults.py.
"""

import dataclasses
import errno as errno_lib
import logging
import os
import re
import tempfile
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from pipelinedp_tpu_torch.runtime.concurrency import guarded_by

_OUT_PREFIX = "out__"
_CRC_KEY = "__crc32__"

# A failed write or fsync is rewritten on a fresh descriptor at most this
# many times (a failed fd is never fsynced again).
_STORAGE_REWRITES = 1


class JournalCorruptionError(RuntimeError):
    """A journal record failed its integrity check."""


class StorageUnavailableError(OSError):
    """The journal's store cannot durably persist a record right now
    (ENOSPC, or a write / fsync that failed again on a fresh descriptor).
    The temporary file was unlinked; the previous record, or none, remains
    the durable truth. The service turns it into a shed with a
    retry-after."""


@dataclasses.dataclass
class BlockRecord:
    """One record: ids and named output columns."""
    ids: np.ndarray
    outputs: Dict[str, np.ndarray]


def _safe(token: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", str(token))


def _payload_crc(payload: Dict[str, np.ndarray]) -> int:
    """CRC32 over the payload arrays: names, dtypes, shapes and bytes, in
    sorted-name order."""
    crc = 0
    for name in sorted(payload):
        a = np.ascontiguousarray(payload[name])
        header = f"{name}|{a.dtype.str}|{a.shape}|".encode()
        crc = zlib.crc32(a.tobytes(), zlib.crc32(header, crc))
    return crc & 0xFFFFFFFF


class BlockJournal:
    """In-memory, optionally directory-backed, record store keyed by
    (job_id, key). Single writer per (directory, job_id)."""

    _GUARDED_BY = guarded_by("_lock", "_mem")

    def __init__(self, directory: Optional[str] = None):
        self._lock = threading.Lock()
        self._mem: Dict[Tuple[str, str], BlockRecord] = {}
        self._dir = directory
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            self._sweep_orphan_tmp(directory)

    @property
    def directory(self) -> Optional[str]:
        """Backing directory (None: in memory only)."""
        return self._dir

    @staticmethod
    def _sweep_orphan_tmp(directory: str) -> None:
        for name in os.listdir(directory):
            if not name.endswith(".tmp"):
                continue
            path = os.path.join(directory, name)
            try:
                os.unlink(path)
                logging.warning("journal: removed orphaned temp file %s "
                                "(a crash mid-write)", path)
            except OSError:
                pass

    def _path(self, job_id: str, key: str) -> str:
        return os.path.join(self._dir, f"{_safe(job_id)}__{_safe(key)}.npz")

    def put(self, job_id: str, key: str, record: BlockRecord) -> None:
        with self._lock:
            self._mem[(job_id, key)] = record
        if self._dir is None:
            return
        payload = {"ids": record.ids}
        for name, col in record.outputs.items():
            payload[_OUT_PREFIX + name] = col
        payload[_CRC_KEY] = np.uint32(_payload_crc(payload))
        from pipelinedp_tpu_torch.runtime import telemetry
        from pipelinedp_tpu_torch.runtime import trace as rt_trace
        with rt_trace.span(
                "journal.put", key=str(key),
                bytes=int(sum(np.asarray(a).nbytes
                              for a in payload.values()))):
            rewrites = 0
            while True:
                fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
                stage = "write"
                try:
                    with os.fdopen(fd, "wb") as f:
                        np.savez(f, **payload)
                        f.flush()
                        stage = "fsync"
                        os.fsync(f.fileno())
                    os.replace(tmp, self._path(job_id, key))
                    break
                except OSError as e:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    full = getattr(e, "errno", None) == errno_lib.ENOSPC
                    if full:
                        telemetry.record("storage_disk_full", key=str(key))
                    elif stage == "fsync":
                        telemetry.record("storage_fsync_failures",
                                         key=str(key))
                    else:
                        telemetry.record("storage_io_errors", key=str(key))
                    rewrites += 1
                    if full or rewrites > _STORAGE_REWRITES:
                        telemetry.record("storage_unavailable",
                                         key=str(key))
                        raise StorageUnavailableError(
                            f"journal record {str(key)!r} for job "
                            f"{job_id!r} could not be persisted "
                            f"({type(e).__name__}: {e}); the tmp file was "
                            f"unlinked and the previous record (or none) "
                            f"remains the durable truth.") from e
                    logging.warning(
                        "journal: %s failed for record %r of job %r (%s); "
                        "rewriting once on a fresh fd.", stage, str(key),
                        job_id, e)
                except BaseException:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                    raise

    def _load_verified(self, path: str) -> BlockRecord:
        """Loads and integrity-checks one record file."""
        with np.load(path, allow_pickle=False) as data:
            payload = {name: data[name] for name in data.files}
        stored = payload.pop(_CRC_KEY, None)
        if stored is None:
            raise JournalCorruptionError(
                f"{path}: no {_CRC_KEY} checksum - unverifiable records "
                f"are never replayed")
        actual = _payload_crc(payload)
        if int(stored) != actual:
            raise JournalCorruptionError(
                f"{path}: checksum mismatch (stored {int(stored):#010x}, "
                f"computed {actual:#010x}) - record is corrupt")
        if "ids" not in payload:
            raise JournalCorruptionError(f"{path}: record has no ids array")
        return BlockRecord(
            ids=payload["ids"],
            outputs={name[len(_OUT_PREFIX):]: col
                     for name, col in payload.items()
                     if name.startswith(_OUT_PREFIX)})

    def _quarantine(self, job_id: str, key: str, path: str,
                    error: BaseException) -> None:
        """Renames a corrupt record aside (``.npz.corrupt``) and counts
        it on the job's health record."""
        from pipelinedp_tpu_torch.runtime import health as rt_health
        from pipelinedp_tpu_torch.runtime import telemetry
        quarantine = path + ".corrupt"
        n = 0
        while os.path.exists(quarantine):
            n += 1
            quarantine = f"{path}.corrupt.{n}"
        try:
            os.replace(path, quarantine)
        except OSError:
            try:
                os.unlink(path)
                quarantine = "<deleted>"
            except OSError:
                logging.error("journal: could not quarantine corrupt "
                              "record %s", path)
                quarantine = "<in place>"
        if rt_health.current() is None:
            with rt_health.track(rt_health.for_job(job_id)):
                telemetry.record("journal_quarantined", key=str(key))
        else:
            telemetry.record("journal_quarantined", key=str(key))
        logging.warning(
            "journal: record %s for job %r key %r failed integrity "
            "verification (%s: %s); quarantined to %s.", path, job_id, key,
            type(error).__name__, str(error).splitlines()[0][:200],
            quarantine)

    def get(self, job_id: str, key: str) -> Optional[BlockRecord]:
        with self._lock:
            record = self._mem.get((job_id, key))
        if record is not None or self._dir is None:
            return record
        path = self._path(job_id, key)
        if not os.path.exists(path):
            return None
        try:
            record = self._load_verified(path)
        # Any load or verify failure: the record cannot be trusted.
        except Exception as e:  # noqa: BLE001
            if isinstance(e, OSError) and \
                    getattr(e, "errno", None) == errno_lib.EIO:
                from pipelinedp_tpu_torch.runtime import telemetry
                telemetry.record("storage_io_errors", key=str(key))
            self._quarantine(job_id, key, path, e)
            return None
        with self._lock:
            self._mem[(job_id, key)] = record
        return record
