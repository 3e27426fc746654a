"""Copy of `repro/core/shards/sharded_graph.py`.

Region-hash-partitioned dependence graph.

The baseline runtime serializes *every* graph mutation on one global
lock (``sync``) or funnels every message through managers that still
share that lock (``dast``/``ddast``) — the residual serialization point
the paper's related work (Álvarez et al. 2021, Yu et al. 2022) attacks
next. Here the graph is split into N independent ``GraphShard``
partitions. A region belongs to shard ``stable_region_hash(region) % N``
— the bare region name, NOT the parent-qualified key, so shard
assignment is reproducible across runs (parent ``wd_id``s come from a
process-global counter) and identical to the simulator's partitioning.
Within a shard the region *map* is keyed by ``(parent_wd_id, region)``
so sibling namespaces stay separate, exactly like the per-parent graphs
of ``depgraph``. Each shard owns its region map, its successor lists,
and its own ``InstrumentedLock``, so mutations on different shards never
contend.

A task whose deps span k shards is joined by a per-WD pending
``AtomicCounter`` (see ``router.ShardRouter`` for the protocol): the
counter starts at k (a "submit latch": +1 per shard portion not yet
inserted), each shard's insert atomically adds ``local_preds - 1``, and
each satisfied edge subtracts 1. The unique decrement that reaches zero
marks the task ready — no shard ever needs another shard's lock.

Why there is no "is the predecessor still alive?" filtering (the
``state not in (COMPLETED, DELETED)`` check of ``depgraph.submit``): a
predecessor found in a shard's region map cannot have had its Done
processed *at this shard* (Done scrubs the region map under the same
shard lock), therefore the matching decrement for any edge recorded
here is still pending and no wakeup can be lost. If the Done won the
race instead, the region entry is already gone and no stale edge is
created — the same semantics the global-lock graph provides, per shard.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Tuple

from ..depgraph import (_RegionState, collect_preds_and_register,
                        scrub_regions)
from ..queues import InstrumentedLock
from ..wd import WorkDescriptor
from .steal_deque import AtomicCounter, stable_region_hash


def _parent_id(wd: WorkDescriptor) -> int:
    return wd.parent.wd_id if wd.parent is not None else -1


def partition_deps(wd: WorkDescriptor, num_shards: int) -> Dict[int, list]:
    """Partition ``wd.deps`` by owning shard: {shard_index: [(map_key,
    mode), ...]} with map_key = (parent_wd_id, region). Shard choice
    hashes the bare region (reproducible + simulator-identical); the
    map key keeps sibling namespaces separate. Computed once per WD and
    cached on it by the router."""
    pid = _parent_id(wd)
    parts: Dict[int, list] = {}
    for region, mode in wd.deps:
        s = stable_region_hash(region) % num_shards
        parts.setdefault(s, []).append(((pid, region), mode))
    return parts


class GraphShard:
    """One partition: a region map + successor lists under one lock.

    ``submit_local`` / ``complete_local`` must be called with ``lock``
    held (the ``ShardRouter`` guarantees additionally that at most one
    manager drains a shard's mailbox at a time, preserving the paper's
    Submit-exclusivity invariant per shard instead of globally).
    """

    __slots__ = ("index", "num_shards", "lock", "_regions", "_succs",
                 "in_shard", "max_in_shard", "total_submitted",
                 "total_edges", "requests", "delegated", "combined",
                 "handoffs", "scope_portions")

    def __init__(self, index: int, num_shards: int) -> None:
        self.index = index
        self.num_shards = num_shards
        self.lock = InstrumentedLock()
        self._regions: Dict[Tuple[int, Any], _RegionState] = {}
        # pred wd_id -> successors whose edge was recorded at THIS shard;
        # decremented by this shard's processing of the pred's Done.
        self._succs: Dict[int, List[WorkDescriptor]] = {}
        self.in_shard = 0
        self.max_in_shard = 0
        self.total_submitted = 0
        self.total_edges = 0
        # -- delegation/combining (see shards.router) ------------------
        # MPSC publication list: producers append their Submit/Done
        # portion here (deque.append is GIL-atomic) and then *compete*
        # for ``lock`` with a trylock; the winner — the combiner —
        # drains this list and applies every published portion in one
        # combined critical section. The three counters are maintained
        # by the combiner only, under ``lock``, so plain ints are safe:
        #   delegated — portions that traversed the publication list
        #               (structural: identical sim-vs-real),
        #   combined  — combine sessions that applied >= 1 portion,
        #   handoffs  — post-release re-acquisitions (the releasing
        #               holder found late-published requests and took
        #               the lock back rather than strand them).
        self.requests: deque = deque()
        self.delegated = 0
        self.combined = 0
        self.handoffs = 0
        # scope -> portions this shard applied for that tenant (None =
        # the scope-less root context); folded into scope_rollup().
        self.scope_portions: Dict[Any, int] = {}

    # ------------------------------------------------------------------
    def local_deps(self, wd: WorkDescriptor):
        """The subset of ``wd.deps`` this shard owns, as (map-key, mode)
        pairs. The partition is computed ONCE per WD by the router
        (``wd.shard_parts``) so the hot path — which runs under the
        shard lock — never re-hashes regions."""
        parts = wd.shard_parts
        if parts is None:               # direct use without a router
            parts = wd.shard_parts = partition_deps(wd, self.num_shards)
        return parts.get(self.index, ())

    def submit_local(self, wd: WorkDescriptor) -> int:
        """Insert this shard's portion of ``wd``; returns the number of
        local predecessor edges recorded (the exact region rules of
        ``DependenceGraph.submit`` via the shared helper, deduplicated
        within the shard). No liveness filter is applied — see the
        module docstring for why every recorded predecessor is live."""
        preds = collect_preds_and_register(self._regions, wd,
                                           self.local_deps(wd))
        for p in preds:
            self._succs.setdefault(p.wd_id, []).append(wd)
        self.total_edges += len(preds)
        self.total_submitted += 1
        self.in_shard += 1
        self.max_in_shard = max(self.max_in_shard, self.in_shard)
        return len(preds)

    def complete_local(self, wd: WorkDescriptor) -> List[WorkDescriptor]:
        """Scrub this shard's portion of a finished ``wd``; returns the
        successors whose edge at this shard is now satisfied."""
        scrub_regions(self._regions, wd, self.local_deps(wd))
        self.in_shard -= 1
        return self._succs.pop(wd.wd_id, [])


class ShardedDependenceGraph:
    """N independent shard partitions + whole-graph occupancy counters."""

    def __init__(self, num_shards: int) -> None:
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self.shards = [GraphShard(i, num_shards) for i in range(num_shards)]
        self._in_graph = AtomicCounter(0)
        self.max_in_graph = 0

    # -- routing -------------------------------------------------------
    def shard_for(self, region: Any) -> int:
        return stable_region_hash(region) % self.num_shards

    def shards_for(self, wd: WorkDescriptor) -> List[int]:
        """Ordered, de-duplicated shard indices touched by ``wd.deps``."""
        return list(partition_deps(wd, self.num_shards))

    # -- whole-graph occupancy (stats parity with DependenceGraph) -----
    def task_entered(self) -> None:
        v = self._in_graph.add(1)
        if v > self.max_in_graph:      # benign race: max may lag briefly
            self.max_in_graph = v

    def task_left(self) -> None:
        self._in_graph.add(-1)

    @property
    def in_graph(self) -> int:
        return self._in_graph.value

    @property
    def total_edges(self) -> int:
        return sum(s.total_edges for s in self.shards)
