"""Per-worker message queues (paper §3.1, Fig. 3); copy of
`repro/core/queues.py`.

Each worker owns one Submit queue and one Done ("others") queue:
  * only the owning worker pushes (single producer),
  * only manager threads pop (possibly several for Done; exactly one at a
    time for Submit — enforced with a try-acquire flag, Listing 2 line 8).

CPython's ``collections.deque`` append/popleft are atomic, giving the
lock-free SPSC/MPMC push/pop the paper's C++ queues provide; the Submit
drain-exclusivity is the only extra synchronization, exactly as in the
paper.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class InstrumentedLock:
    """Lock that records contention (acquisitions + wait time).

    Used for the global graph lock in ``sync`` mode and for each shard
    lock in ``sharded`` mode, so per-organization lock-wait numbers are
    directly comparable (the paper's §1 motivation metric).
    """

    __slots__ = ("_lock", "acquisitions", "wait_s")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.acquisitions = 0
        self.wait_s = 0.0

    def __enter__(self) -> "InstrumentedLock":
        t0 = time.perf_counter()
        self._lock.acquire()
        self.wait_s += time.perf_counter() - t0
        self.acquisitions += 1
        return self

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        return False

    # -- delegation/combining fast path --------------------------------
    def try_acquire(self) -> bool:
        """Non-blocking acquire: counts the acquisition on success and
        never accrues wait time — a failed trylock is exactly the wait
        the delegation/combining protocol turns into a published request
        (``shards.router``), so by construction ``wait_s`` stays zero on
        that path."""
        if self._lock.acquire(blocking=False):
            self.acquisitions += 1
            return True
        return False

    def release(self) -> None:
        self._lock.release()


class SPSCQueue(Generic[T]):
    __slots__ = ("_q", "pushed", "popped")

    def __init__(self) -> None:
        self._q: deque = deque()
        self.pushed = 0
        self.popped = 0

    def push(self, item: T) -> None:
        self._q.append(item)
        self.pushed += 1

    def pop(self) -> Optional[T]:
        try:
            item = self._q.popleft()
        except IndexError:
            return None
        self.popped += 1
        return item

    def peek(self) -> Optional[T]:
        """Head without removal (GIL-atomic index read). Stable only for
        the exclusive Submit drainer; a racing Done drainer may observe a
        head another manager pops first — callers there must re-read the
        actual popped item."""
        try:
            return self._q[0]
        except IndexError:
            return None

    def __len__(self) -> int:
        return len(self._q)


class WorkerQueues:
    """The queue pair owned by one worker thread."""

    def __init__(self, worker_id: int) -> None:
        self.worker_id = worker_id
        self.submit: SPSCQueue = SPSCQueue()
        self.done: SPSCQueue = SPSCQueue()
        self._submit_drain_flag = threading.Lock()

    # -- Submit-queue exclusivity (one manager at a time, in order) ----
    def acquire_submit(self) -> bool:
        return self._submit_drain_flag.acquire(blocking=False)

    def release_submit(self) -> None:
        self._submit_drain_flag.release()

    def pending(self) -> int:
        return len(self.submit) + len(self.done)
