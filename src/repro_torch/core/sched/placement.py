"""Copy of `repro/core/sched/placement.py`.

Placement policies: who gets a newly-ready task, and in what lane.

The Distributed Breadth-First ready pool (paper §4, point 4) is one
lock-free :class:`~repro_torch.core.shards.StealDeque` per worker slot: the
owner pops LIFO from the hot end, thieves steal FIFO from the cold end.
The :class:`PlacementPolicy` owns those deques and decides which deque a
ready task lands on; it is mode-agnostic — every
:class:`~repro_torch.core.engine.policy.DependencePolicy` pushes through it and
both drivers (threads and simulator) pop through it.

Three implementations:

  * :class:`RoundRobinPlacement` — the historical default: spread ready
    tasks evenly; the unguarded cursor update is a benign race (any value
    it yields is a valid target index).
  * :class:`ShardAffinePlacement` — push a ready task onto the deque of
    the worker that last *executed* a task touching one of its regions
    (cache locality: the region's blocks are warm in that core's cache).
    Falls back to round-robin when no affinity is known yet, and skips
    affinity when the preferred deque is far above the ring-average load
    (a hot region must not pile the whole graph onto one slot). The
    affinity map is updated by the driver via :meth:`note_executed`.
  * :class:`CriticalPathPlacement` — the replay-aware scheduler: while a
    frozen :class:`~repro_torch.core.engine.replay.ReplayGraph` is active, the
    :class:`~repro_torch.core.engine.replay.ReplayPolicy` publishes per-task
    bottom levels (critical-path priorities computed ONCE at freeze time
    from the frozen successor arrays and the recorded per-task cost
    EMAs, :func:`~repro_torch.core.sched.dag.bottom_levels`) through
    :meth:`set_replay_priorities`; ready tasks are then pushed into the
    priority lane of the two-lane deques so the longest remaining chain
    is always started first. Outside replay (live iterations, divergence
    suffixes, non-replay runtimes) it degrades to the inherited
    shard-affine/round-robin behavior. The priority lane is banded
    GIL-atomic deques (see :class:`~repro_torch.core.shards.StealDeque`), so
    it reintroduces no lock, global or otherwise.

Placements charge their priority-lane traffic through ``self.charge`` —
a no-op for the threaded driver; the simulator's
:class:`~repro_torch.core.engine.charge.SimCharger` prices each priority push
and each pop-side band scan in virtual time.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Sequence

from ..shards import AtomicCounter, StealDeque, stable_region_hash
from ..trace import EV_READY, EV_STEAL, NULL_TRACER
from ..wd import WorkDescriptor
from .dag import quantize_bands


class _NullCharger:
    """Stand-in until a DependencePolicy wires its real CostCharger in
    (placements must not import the engine package: the engine imports
    this module)."""

    __slots__ = ()

    def prio_push(self) -> None:
        pass

    def prio_pop(self) -> None:
        pass


_NO_CHARGE = _NullCharger()


class PlacementPolicy:
    """Owns the per-slot ready deques; subclasses choose the target."""

    #: True when the placement consumes replay-time priorities — the
    #: replay wrapper only computes bottom levels for placements that
    #: want them.
    wants_replay_priorities = False

    def __init__(self, num_slots: int) -> None:
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.deques: List[StealDeque] = [StealDeque()
                                         for _ in range(num_slots)]
        self.charge = _NO_CHARGE
        # wired by the DependencePolicy ctor, like `charge`; `ready`
        # events are stamped HERE because every ready path of every
        # policy funnels through a placement push, and only the
        # placement knows the target slot
        self.tracer = NULL_TRACER
        # per-scope steal tallies for the multi-tenant rollups
        # (dict.setdefault is GIL-atomic; AtomicCounter guards the +=)
        self.scope_steals: Dict[Hashable, AtomicCounter] = {}

    # -- protocol -------------------------------------------------------
    def push(self, wd: WorkDescriptor) -> None:
        raise NotImplementedError

    def push_replay(self, wd: WorkDescriptor, sid: int) -> None:
        """A replayed task became ready; ``sid`` is its structural id in
        the active :class:`~repro_torch.core.engine.replay.ReplayGraph`.
        Default: ignore the id, place like any other task."""
        self.push(wd)

    def pop(self, slot: int) -> Optional[WorkDescriptor]:
        """Own deque first (priority bands, then the LIFO end), then
        steal around the ring (FIFO end, O(1) per attempt)."""
        wd = self.deques[slot].pop()
        if wd is not None:
            return wd
        n = len(self.deques)
        for off in range(1, n):
            victim = (slot + off) % n
            wd = self.deques[victim].steal()
            if wd is not None:
                self._note_steal(wd, slot, victim)
                return wd
        return None

    def _note_steal(self, wd: WorkDescriptor, slot: int,
                    victim: int) -> None:
        """A ready task left ``victim``'s deque for thief ``slot``."""
        if wd.scope is not None:
            self.scope_steals.setdefault(
                wd.scope, AtomicCounter(0)).add(1)
        if self.tracer.enabled:
            self.tracer.task_event(EV_STEAL, wd, slot, data=victim)

    def ready_count(self) -> int:
        return sum(len(d) for d in self.deques)

    def note_executed(self, wd: WorkDescriptor, slot: int) -> None:
        """Driver hook after a task body ran on ``slot``. Default: no
        bookkeeping."""

    # -- replay-priority hooks (no-ops outside CriticalPathPlacement) ---
    def set_replay_priorities(self, levels: Sequence[float],
                              scope: Optional[Hashable] = None) -> None:
        """Freeze-time hook: per-sid bottom levels of the active replay
        graph. ``scope`` (multi-tenant) publishes a per-scope band table
        instead of the exclusive single-tenant one."""

    def clear_replay_priorities(self,
                                scope: Optional[Hashable] = None) -> None:
        """The active recording was retired; drop priority state (for
        one tenant when ``scope`` is given)."""

    def stats(self) -> Dict[str, int]:
        return {
            "pushed": sum(d.pushed for d in self.deques),
            "popped": sum(d.popped for d in self.deques),
            "stolen": sum(d.stolen for d in self.deques),
        }


class RoundRobinPlacement(PlacementPolicy):
    """Spread ready tasks evenly across the slots (historical default)."""

    def __init__(self, num_slots: int) -> None:
        super().__init__(num_slots)
        self._rr = 0

    def push(self, wd: WorkDescriptor) -> None:
        slot = self._rr
        self.deques[slot].push(wd)
        self._rr = (slot + 1) % len(self.deques)
        if self.tracer.enabled:
            self.tracer.task_event(EV_READY, wd, slot)


class ShardAffinePlacement(RoundRobinPlacement):
    """Prefer the deque of the worker that last touched the task's
    regions; falls back to the inherited round-robin push when no
    affinity is recorded.

    With ``num_shards`` set (the drivers pass their shard count), the
    map is keyed by SHARD ID — ``stable_region_hash(region) %
    num_shards``, the same partition function the sharded graph uses —
    instead of the exact region. That hard-bounds the map at
    ``num_shards`` entries on region-churning workloads (a streaming app
    touches unbounded regions but a fixed set of shards) and matches the
    locality the sharded manager creates anyway: tasks whose regions
    share a shard already share manager/lock cache lines. Without
    ``num_shards`` (direct construction) the exact-region keying and the
    bounded LRU (``max_regions`` entries, default 4096) remain.

    Affinity additionally yields to load: when the preferred deque's
    normal lane is already more than twice the average of the other
    slots' lanes (and non-trivially long — see ``_LOAD_CAP_MIN``), the
    push falls back to round-robin.
    Without the cap a single hot region (e.g. the sparse-LU diagonal
    block) funnels every dependent task onto one slot while the other
    workers burn cycles stealing one task at a time from its cold end.

    Reads and writes of the affinity map take a small lock — eviction
    mutates the ordered map, so the GIL alone is not enough — which is
    acceptable because this placement is opt-in and the critical section
    is two dict operations."""

    #: below this target-deque length the load cap never triggers (a cap
    #: on near-empty deques would just add noise to the affinity win)
    _LOAD_CAP_MIN = 4

    def __init__(self, num_slots: int, max_regions: int = 4096,
                 num_shards: Optional[int] = None) -> None:
        super().__init__(num_slots)
        self._affinity: "OrderedDict[Hashable, int]" = OrderedDict()
        self._max_regions = max(1, max_regions)
        self._num_shards = num_shards
        self._aff_lock = threading.Lock()
        self.affine_pushes = 0
        self.fallback_pushes = 0
        self.load_cap_skips = 0

    def _key(self, region: Hashable) -> Hashable:
        if self._num_shards:
            return stable_region_hash(region) % self._num_shards
        return region

    def set_num_shards(self, num_shards: int) -> None:
        """Re-key after an online shard-count retune
        (``ShardedPolicy.resize``): old buckets are meaningless under
        the new modulus, so the hint map is cleared — affinity rebuilds
        from the next executions, which is the same cold start a resize
        imposes on the shards themselves."""
        with self._aff_lock:
            # exact-region keying (None) is a deliberate construction
            # choice — a resize must not convert it to shard keying
            if self._num_shards is not None \
                    and num_shards != self._num_shards:
                self._num_shards = num_shards
                self._affinity.clear()

    def preferred_slot(self, wd: WorkDescriptor) -> Optional[int]:
        n = len(self.deques)
        slot = None
        with self._aff_lock:
            for region, _mode in wd.deps:
                s = self._affinity.get(self._key(region))
                if s is not None and s < n:
                    slot = s
                    break
        if slot is None:
            return None
        # Load cap over the NORMAL lanes only (lane_len is O(1); banded
        # priority work is drained from any deque highest-first, so it
        # never pins to the owner): yield affinity when the target lane
        # is more than twice the average of the OTHER slots' lanes.
        qlen = self.deques[slot].lane_len
        if qlen >= self._LOAD_CAP_MIN and n > 1:
            rest = sum(d.lane_len for d in self.deques) - qlen
            if qlen * (n - 1) > 2 * rest:
                self.load_cap_skips += 1
                return None
        return slot

    def push(self, wd: WorkDescriptor) -> None:
        slot = self.preferred_slot(wd)
        if slot is None:
            self.fallback_pushes += 1
            super().push(wd)            # inherited round-robin spread
            return
        self.affine_pushes += 1
        self.deques[slot].push(wd)
        if self.tracer.enabled:
            # the "affine" payload marks locality-pinned placements for
            # the affinity-miss detector
            self.tracer.task_event(EV_READY, wd, slot, data="affine")

    def note_executed(self, wd: WorkDescriptor, slot: int) -> None:
        with self._aff_lock:
            for region, _mode in wd.deps:
                key = self._key(region)
                self._affinity[key] = slot
                self._affinity.move_to_end(key)
            while len(self._affinity) > self._max_regions:
                self._affinity.popitem(last=False)

    def stats(self) -> Dict[str, int]:
        st = super().stats()
        st["affine_pushes"] = self.affine_pushes
        st["fallback_pushes"] = self.fallback_pushes
        st["load_cap_skips"] = self.load_cap_skips
        return st


class CriticalPathPlacement(ShardAffinePlacement):
    """Critical-path-aware placement over frozen replay graphs.

    While the record-and-replay wrapper has an active frozen recording it
    publishes each task's bottom level (critical-path priority) here,
    quantized once into discrete bands; :meth:`push_replay` then pushes
    each newly-ready task into the priority lane of the chosen deque at
    its precomputed band, so every owner pop and every steal starts the
    longest remaining chain first. Everything else — live iterations,
    divergence suffixes, non-replay runtimes — flows through the
    inherited shard-affine/round-robin path unchanged.
    """

    wants_replay_priorities = True

    def __init__(self, num_slots: int, max_regions: int = 4096,
                 num_shards: Optional[int] = None,
                 max_bands: int = 32) -> None:
        super().__init__(num_slots, max_regions, num_shards)
        self.max_bands = max(1, max_bands)
        self._bands_of: Optional[List[int]] = None
        # band-indexed global occupancy counters shared by all deques
        # (GIL-atomic hint — see StealDeque): lets pop find the best
        # band across the WHOLE ring, making the longest-remaining-chain
        # guarantee global instead of per-deque
        self._band_counts: Optional[List[int]] = None
        # Multi-tenant: per-scope band tables, every value pre-scaled
        # into one FIXED universe of ``max_bands`` bands so all tenants
        # share the same band array and the same occupancy counters —
        # pop's global best-band choice then ranks every tenant's
        # critical work on one axis (longest-chain-first is global
        # again, not per-tenant). The fixed universe is configured once
        # (first scoped publication, priority lanes still empty) and
        # never reallocated: a tenant freezing or retiring while others
        # have banded work in flight must not orphan their entries.
        self._scope_bands: Dict[Hashable, List[int]] = {}
        # guards band-array (re)configuration: two tenants' first scoped
        # publications run on their own worker threads, and an unguarded
        # check-then-act could bind half the deques to one counts list
        # and half to another, desyncing occupancy from band contents
        self._universe_lock = threading.Lock()
        self.priority_pushes = 0
        self.global_band_steals = 0

    @property
    def replay_priorities_active(self) -> bool:
        return self._bands_of is not None or bool(self._scope_bands)

    def _ensure_scope_universe(self) -> bool:
        """Configure the fixed ``max_bands`` band array shared by all
        scoped tables (under ``_universe_lock``: concurrent first
        publications must not interleave the per-deque rebinding loop).
        Returns False when a single-tenant table already holds the
        deques at a different width — reconfiguring would orphan its
        in-flight banded tasks, so the scoped publication is declined
        and that tenant degrades to the normal lane."""
        with self._universe_lock:
            if self._band_counts is not None:
                return len(self._band_counts) == self.max_bands
            counts = [0] * self.max_bands
            for d in self.deques:
                d.set_num_bands(self.max_bands, counts)
            self._band_counts = counts
            return True

    def set_replay_priorities(self, levels: Sequence[float],
                              scope: Optional[Hashable] = None) -> None:
        """Publish per-sid bottom levels (called at freeze time and
        refreshed from the cost EMAs at replay iteration boundaries —
        root-quiescent for the publishing tenant, so its own banded
        entries are drained and the table swap races with nothing)."""
        if scope is not None:
            if not self._ensure_scope_universe():
                return
            bands, nbands = quantize_bands(levels, self.max_bands)
            scale = self.max_bands
            self._scope_bands[scope] = [b * scale // nbands
                                        for b in bands]
            return
        with self._universe_lock:
            if not self._scope_bands:
                # exclusive single-tenant publication: size the band
                # array to exactly what this table needs (reallocation
                # is safe — publication is root-quiescent, so the only
                # banded in-flight tasks were this tenant's, now drained)
                bands, nbands = quantize_bands(levels, self.max_bands)
                counts = [0] * nbands
                for d in self.deques:
                    d.set_num_bands(nbands, counts)
                self._band_counts = counts
                self._bands_of = bands
                return
        # Scoped tables are live (or a band array already exists):
        # reallocating would empty every band deque and orphan other
        # tenants' banded in-flight tasks — the same hazard
        # _ensure_scope_universe guards against in the opposite
        # direction. Publish the root table into the fixed max_bands
        # universe instead, exactly like a scoped publication.
        if not self._ensure_scope_universe():
            return
        bands, nbands = quantize_bands(levels, self.max_bands)
        scale = self.max_bands
        self._bands_of = [b * scale // nbands for b in bands]

    def clear_replay_priorities(self,
                                scope: Optional[Hashable] = None) -> None:
        if scope is not None:
            # drop only this tenant's table; the fixed band array stays
            # so other tenants' banded in-flight work keeps draining
            self._scope_bands.pop(scope, None)
            return
        self._bands_of = None
        with self._universe_lock:
            if not self._scope_bands and self._band_counts is not None:
                self._band_counts = None
                for d in self.deques:
                    d.set_num_bands(0)

    def _band_for(self, wd: WorkDescriptor, sid: int) -> int:
        """The band of a ready replayed task: its tenant's table when
        one is published, else the single-tenant table; -1 = no band."""
        if wd.scope is not None:
            bands = self._scope_bands.get(wd.scope)
            if bands is not None and 0 <= sid < len(bands):
                return bands[sid]
            return -1
        bands = self._bands_of
        if bands is not None and 0 <= sid < len(bands):
            return bands[sid]
        return -1

    def push_replay(self, wd: WorkDescriptor, sid: int) -> None:
        band = self._band_for(wd, sid)
        if band < 0:
            self.push(wd)
            return
        self.charge.prio_push()
        slot = self.preferred_slot(wd)
        if slot is None:
            self.fallback_pushes += 1
            slot = self._rr
            self._rr = (self._rr + 1) % len(self.deques)
        else:
            self.affine_pushes += 1
        self.priority_pushes += 1
        self.deques[slot].push_priority(wd, band)
        if self.tracer.enabled:
            # published-band payload: the priority-inversion detector
            # only speaks where bands exist
            self.tracer.task_event(EV_READY, wd, slot,
                                   data=("band", band))

    def pop(self, slot: int) -> Optional[WorkDescriptor]:
        # Global priority pop: when the shared band counters say a
        # better band exists somewhere in the ring than anything in the
        # own deque, steal from THAT band first — the
        # longest-remaining-chain guarantee becomes global, not
        # per-deque. The counters are a hint (see StealDeque): a stale
        # entry just falls through to the normal own-pop/steal path.
        counts = self._band_counts
        if counts is not None:
            gb = -1
            for b in range(len(counts) - 1, -1, -1):
                if counts[b] > 0:
                    gb = b
                    break
            if gb >= 0 and self.deques[slot].best_band() < gb:
                n = len(self.deques)
                for off in range(1, n):
                    victim = (slot + off) % n
                    wd = self.deques[victim].steal_band(gb)
                    if wd is not None:
                        self.global_band_steals += 1
                        self._note_steal(wd, slot, victim)
                        self.charge.prio_pop()
                        return wd
        wd = super().pop(slot)
        if wd is not None and self.replay_priorities_active:
            self.charge.prio_pop()      # the pop-side band scan
        return wd

    def stats(self) -> Dict[str, int]:
        st = super().stats()
        st["priority_pushes"] = self.priority_pushes
        st["global_band_steals"] = self.global_band_steals
        return st


_PLACEMENTS = {
    "round_robin": RoundRobinPlacement,
    "shard_affine": ShardAffinePlacement,
    "critical_path": CriticalPathPlacement,
}

PLACEMENT_NAMES = tuple(_PLACEMENTS)


def make_placement(kind, num_slots: int,
                   num_shards: Optional[int] = None) -> PlacementPolicy:
    """``kind`` is a name from ``_PLACEMENTS``, an already-built
    :class:`PlacementPolicy` (returned as-is), or a class to
    instantiate. ``num_shards`` (from the driver) switches
    shard-affine placements to bounded shard-id affinity keying."""
    if isinstance(kind, PlacementPolicy):
        if len(kind.deques) != num_slots:
            raise ValueError(
                f"placement instance has {len(kind.deques)} deques, "
                f"driver needs {num_slots}")
        return kind
    if isinstance(kind, type) and issubclass(kind, PlacementPolicy):
        cls = kind
    else:
        try:
            cls = _PLACEMENTS[kind]
        except KeyError:
            raise ValueError(
                f"placement must be one of {sorted(_PLACEMENTS)}, "
                f"got {kind!r}")
    if num_shards and issubclass(cls, ShardAffinePlacement):
        return cls(num_slots, num_shards=num_shards)
    return cls(num_slots)
