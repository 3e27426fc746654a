"""Copy of `repro/core/shards/steal_deque.py`.

Lock-free primitives for the sharded dependence manager.

``StealDeque`` is the per-worker ready pool of Distributed Breadth-First
scheduling without the global ready lock the baseline runtime used: the
owner pops LIFO from the hot end (cache-warm, newest task first) while
thieves steal FIFO from the cold end (oldest task first — the classic
Chase-Lev / Cilk discipline). In CPython ``collections.deque`` append /
pop / popleft are each atomic under the GIL, so owner and thief never
corrupt the structure; a concurrent pop+steal race on a single remaining
element resolves to exactly one winner (the loser sees ``IndexError`` and
reports empty). This also fixes the O(n) ``list.pop(0)`` steal of the
previous implementation — ``popleft`` is O(1). The deque is two-lane:
an optional banded priority lane (one GIL-atomic deque per discrete
priority band, highest band drained first) serves the critical-path
replay placement without reintroducing any lock.

``AtomicCounter`` is the per-WD pending-predecessor join counter used by
cross-shard tasks: every shard portion of a Submit adds its local
predecessor count, every satisfied edge subtracts one, and the unique
caller that observes zero marks the task ready. CPython has no lock-free
fetch-add, so a private lock guards the two-instruction update; the
counter is per-task, touched only a handful of times, and therefore never
a contention point (that is the whole idea of the subsystem).

``stable_region_hash`` partitions regions across shards. ``hash()`` is
salted per process for strings, which would make shard assignment — and
with it every per-shard statistic — unreproducible across runs, so we
hash the ``repr`` with crc32 instead: stable, cheap, and good enough
spread for block-index tuples like ``("M", i, j)``.
"""
from __future__ import annotations

import threading
import zlib
from collections import deque
from typing import Any, Generic, Optional, TypeVar

T = TypeVar("T")


def stable_region_hash(key: Any) -> int:
    """Deterministic (cross-process) non-negative hash of a region key.

    crc32 alone is linear: two reprs differing in one digit produce a
    fixed XOR delta that often misses the low bits, so ``% num_shards``
    would lump adjacent block ids onto one shard. The murmur3 fmix32
    finalizer below is nonlinear and spreads any input difference across
    all 32 bits, making small-modulus partitioning uniform."""
    h = zlib.crc32(repr(key).encode("utf-8", "backslashreplace"))
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


class AtomicCounter:
    """Lock-guarded integer with a fetch-add that returns the new value."""

    __slots__ = ("_value", "_lock")

    def __init__(self, value: int = 0) -> None:
        self._value = value
        self._lock = threading.Lock()

    def add(self, delta: int) -> int:
        with self._lock:
            self._value += delta
            return self._value

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"AtomicCounter({self._value})"


class StealDeque(Generic[T]):
    """Per-worker TWO-LANE ready deque: a normal lane with owner-side
    LIFO pop / thief-side FIFO steal, plus an optional banded *priority
    lane* consumed before it.

    Push may come from any thread (managers make tasks ready); deque
    append is atomic, so no producer lock is needed either.

    The priority lane (used by the critical-path replay placement) is a
    list of GIL-atomic deques, one per discrete priority band — highest
    band drained first by owner and thieves alike, so the longest
    remaining chain is always started before breadth work. A banded
    array instead of a heap is what keeps the lane lock-free: every
    band operation is a single atomic ``deque`` append/pop, and a
    concurrent pop+steal race on a band's last element resolves to
    exactly one winner just like the normal lane. Within a band the
    owner pops the hot end (LIFO) and thieves the cold end (FIFO) — the
    classic discipline per band. ``set_num_bands`` swaps the band array
    wholesale and must only be called at quiescent points (the replay
    freeze / iteration boundaries, where the deques are empty).

    ``shared_counts`` (optional, installed by ``set_num_bands``) is a
    band-indexed list of occupancy counters SHARED across all deques of
    one placement: every band push increments its entry, every band
    pop/steal decrements it, so a popper can find the best band across
    the whole ring in O(bands) without touching any other deque. The
    updates are plain GIL-interleavable ``+=``/``-=`` — the counters
    are a *hint*, never load-bearing: a stale positive entry costs one
    wasted cross-deque scan, a stale zero merely loses the global-order
    improvement for one pop (the per-deque band scan below still drains
    every band, so no task can be stranded).
    """

    __slots__ = ("_q", "_bands", "_counts", "pushed", "popped", "stolen")

    def __init__(self, num_bands: int = 0) -> None:
        self._q: deque = deque()
        self._bands: list = [deque() for _ in range(num_bands)]
        self._counts: Optional[list] = None
        self.pushed = 0
        self.popped = 0
        self.stolen = 0

    def set_num_bands(self, num_bands: int,
                      shared_counts: Optional[list] = None) -> None:
        """(Re)allocate the priority lane. Quiescent points only: items
        still sitting in the old band array would be orphaned."""
        self._bands = [deque() for _ in range(num_bands)]
        self._counts = shared_counts

    @property
    def num_bands(self) -> int:
        return len(self._bands)

    def push(self, item: T) -> None:
        self._q.append(item)
        self.pushed += 1

    def push_priority(self, item: T, band: int) -> None:
        """Priority lane: ``band`` indexes the band array (higher =
        drained first)."""
        self._bands[band].append(item)
        if self._counts is not None:
            self._counts[band] += 1
        self.pushed += 1

    def best_band(self) -> int:
        """Highest non-empty band of THIS deque (O(bands) emptiness
        scan), -1 when the priority lane is empty."""
        for b in range(len(self._bands) - 1, -1, -1):
            if self._bands[b]:
                return b
        return -1

    def steal_band(self, band: int) -> Optional[T]:
        """Thief-side pop from one specific band (the cross-deque
        global-best-band scan); None when that band is empty here."""
        bands = self._bands
        if not 0 <= band < len(bands) or not bands[band]:
            return None
        try:
            item = bands[band].popleft()
        except IndexError:
            return None
        if self._counts is not None:
            self._counts[band] -= 1
        self.stolen += 1
        return item

    def pop(self) -> Optional[T]:
        """Owner side: highest priority band first, then the normal
        lane's newest task (LIFO — cache-warm end). The emptiness
        pre-checks keep the idle-spin path free of raised exceptions;
        the try/except still arbitrates the last-element pop+steal
        race."""
        for i in range(len(self._bands) - 1, -1, -1):
            b = self._bands[i]
            if not b:
                continue
            try:
                item = b.pop()
            except IndexError:
                continue
            if self._counts is not None:
                self._counts[i] -= 1
            self.popped += 1
            return item
        if not self._q:
            return None
        try:
            item = self._q.pop()
        except IndexError:
            return None
        self.popped += 1
        return item

    def steal(self) -> Optional[T]:
        """Thief side: highest priority band first (critical work is
        globally urgent), then the normal lane's oldest task (FIFO — the
        breadth-first end); FIFO within each band."""
        for i in range(len(self._bands) - 1, -1, -1):
            b = self._bands[i]
            if not b:
                continue
            try:
                item = b.popleft()
            except IndexError:
                continue
            if self._counts is not None:
                self._counts[i] -= 1
            self.stolen += 1
            return item
        if not self._q:
            return None
        try:
            item = self._q.popleft()
        except IndexError:
            return None
        self.stolen += 1
        return item

    @property
    def lane_len(self) -> int:
        """Length of the normal lane alone — O(1), used by the
        shard-affine load cap (priority-lane work is excluded there:
        banded items are drained highest-first by owner and thieves
        alike, so they never pin to the owner the way the LIFO lane
        does)."""
        return len(self._q)

    def __len__(self) -> int:
        n = len(self._q)
        for b in self._bands:
            n += len(b)
        return n
