"""Copy of `repro/core/metrics/shm_plane.py`.

Shared-memory counter plane for the process backend.

Worker processes cannot write parent-side instrument lists, and
shipping counter updates over the mailbox rings would add IPC frames
to the hot path — the exact cost the metrics plane promises not to
pay. Instead the parent allocates one tiny shm segment laid out as a
``num_workers x len(FIELDS)`` float64 matrix; worker *i* writes only
row *i* (single-writer, so a plain 8-byte store is the whole
protocol — no lock, no fence beyond the hardware's natural aligned-
store atomicity, and a torn read would merely smear one sample), and
the parent scrapes the matrix at sampling time with zero extra IPC
frames.

Ownership follows the ring discipline (``procs.rings``): the parent
creates and is the sole unlinker; workers attach by name and close
without unlinking. A torn float64 is not possible on any platform we
run on (aligned 8-byte stores), and even a stale row only delays one
sample by one scrape.
"""
from __future__ import annotations

from multiprocessing import shared_memory
from typing import Dict, List

__all__ = ["PLANE_FIELDS", "ShmCounterPlane", "WorkerCounterView"]

#: column layout of one worker row (all float64); ``sync_time_s``, the
#: port's one addition, sums the device synchronisations that end a task
#: whose body used CUDA (it is also inside ``exec_time_s``)
PLANE_FIELDS = ("tasks_started", "tasks_finished", "exec_time_s", "busy",
                "sync_time_s")
_NF = len(PLANE_FIELDS)


class ShmCounterPlane:
    """Parent side: create, scrape, unlink."""

    def __init__(self, num_workers: int) -> None:
        self.num_workers = num_workers
        size = 8 * _NF * max(num_workers, 1)
        self.shm = shared_memory.SharedMemory(create=True, size=size)
        self.shm.buf[:size] = b"\x00" * size
        self.name = self.shm.name
        self._d = self.shm.buf.cast("d")

    # -- read side ------------------------------------------------------
    def row(self, widx: int) -> Dict[str, float]:
        base = widx * _NF
        d = self._d
        return {f: d[base + i] for i, f in enumerate(PLANE_FIELDS)}

    def totals(self) -> Dict[str, float]:
        out = dict.fromkeys(PLANE_FIELDS, 0.0)
        d = self._d
        for w in range(self.num_workers):
            base = w * _NF
            for i, f in enumerate(PLANE_FIELDS):
                out[f] += d[base + i]
        return out

    def busy_count(self) -> int:
        d = self._d
        return sum(1 for w in range(self.num_workers)
                   if d[w * _NF + PLANE_FIELDS.index("busy")] > 0.0)

    def snapshot(self) -> Dict[str, object]:
        rows: List[Dict[str, float]] = [self.row(w)
                                        for w in range(self.num_workers)]
        return {"per_worker": rows, "totals": self.totals()}

    def close_unlink(self) -> None:
        try:
            self._d.release()
        except (BufferError, ValueError):
            pass
        try:
            self.shm.close()
        except (BufferError, OSError):
            pass
        try:
            self.shm.unlink()
        except (FileNotFoundError, OSError):
            pass


class WorkerCounterView:
    """Worker side: attach by name, stamp row ``widx`` only."""

    __slots__ = ("shm", "_d", "_base")

    def __init__(self, name: str, widx: int) -> None:
        # plain attach: every attacher is a multiprocessing child of
        # the creator (the fork server hands each child the creator's
        # resource_tracker), so the re-register is a no-op (see
        # procs.rings.attach_shm for the bpo-39959 story)
        self.shm = shared_memory.SharedMemory(name=name)
        self._d = self.shm.buf.cast("d")
        self._base = widx * _NF

    # -- hot path (one aligned f64 store per field) ---------------------
    def task_start(self) -> None:
        b = self._base
        d = self._d
        d[b + 0] += 1.0              # tasks_started
        d[b + 3] = 1.0               # busy

    def task_end(self, dur_s: float, sync_s: float = 0.0) -> None:
        b = self._base
        d = self._d
        d[b + 1] += 1.0              # tasks_finished
        d[b + 2] += dur_s            # exec_time_s
        d[b + 3] = 0.0               # busy
        d[b + 4] += sync_s           # sync_time_s

    def close(self) -> None:
        try:
            self._d.release()
        except (BufferError, ValueError):
            pass
        try:
            self.shm.close()
        except (BufferError, OSError):
            pass
