"""Copy of `repro/core/engine/policy.py`.

The mode-agnostic dependence-policy engine.

The paper's §6 comparison set (plus the sharded extension) differs only
in *how* dependence-graph actions get applied — directly under a lock,
or requested asynchronously and drained by managers. That "how" is a
policy over one set of runtime structures, captured here as the
:class:`DependencePolicy` protocol:

    submit(wd, slot)        a worker created a task
    complete(wd, slot)      a worker finished a task's body
    idle_callback(slot)     an idle worker offers cycles (Listing 2)
    drain_all()             drain every queue to empty (taskwait edges)
    flush(slot)             make the slot's buffered submits visible
    pending() / in_graph()  backlog and occupancy probes
    stats()                 the counters the paper plots

Four concrete policies:

  * :class:`SyncPolicy`    — Nanos++ baseline: mutate directly under ONE
    global graph lock at submit & finish.
  * :class:`DastPolicy`    — the authors' earlier centralized design [7]:
    one dedicated manager thread drains all queues.
  * :class:`DdastPolicy`   — this paper: no dedicated resources; idle
    workers become managers (Listing 2 with the four Table-5 tunables).
  * :class:`ShardedPolicy` — beyond the paper: region-hash-partitioned
    graph shards with per-shard mailboxes; idle workers claim whole
    shards; optional Submit batching (one mailbox entry per task batch).

Policies are driver-agnostic: ``TaskRuntime`` runs them on real threads
with a no-op :class:`~repro_torch.core.engine.charge.CostCharger`;
``RuntimeSimulator`` runs the *same objects* single-threaded under a
:class:`~repro_torch.core.engine.charge.SimCharger` that prices every protocol
step in virtual time. The dependence protocol therefore exists exactly
once.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from ..ddast import DDASTParams
from ..depgraph import DependenceGraph
from ..messages import DoneTaskMessage, SubmitTaskMessage
from ..queues import InstrumentedLock, WorkerQueues
from ..shards import ShardRouter, ShardedDependenceGraph
from ..trace import EV_DEPS, EV_MSG_DRAIN, EV_MSG_ENQ, NULL_TRACER
from ..wd import WorkDescriptor
from .charge import CostCharger
from .placement import PlacementPolicy, RoundRobinPlacement


class DependencePolicy:
    """Protocol base. Also serves as the compat surface the runtime used
    to expose as ``rt.ddast`` (callback / messages_processed /
    callback_entries / drain_all work on every policy)."""

    name = "abstract"
    #: one dedicated manager thread drains continuously (dast)
    needs_manager_thread = False
    #: idle workers should run ``idle_callback`` (ddast / sharded)
    uses_idle_managers = False
    #: driver hint: how long an idle thread sleeps between polls
    idle_sleep_s = 0.0

    def __init__(self, num_slots: int, num_workers: Optional[int] = None,
                 params: Optional[DDASTParams] = None,
                 placement: Optional[PlacementPolicy] = None,
                 charge: Optional[CostCharger] = None,
                 manager_eligible: Optional[Set[int]] = None,
                 main_slot: Optional[int] = None,
                 tracer=None) -> None:
        self.num_slots = num_slots
        self.num_workers = num_workers if num_workers is not None \
            else num_slots
        self.params = params or DDASTParams()
        self.placement = placement or RoundRobinPlacement(num_slots)
        self.charge = charge or CostCharger()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # placements charge their priority-lane traffic through the same
        # adapter the policy uses (no-op on threads, priced in the sim)
        # — and stamp their ready/steal events through the same tracer
        self.placement.charge = self.charge
        self.placement.tracer = self.tracer
        # big.LITTLE support (paper §8): restrict which workers may become
        # manager threads (None = any). The main slot is always eligible
        # so taskwait drains.
        self.manager_eligible = manager_eligible
        self.main_slot = main_slot if main_slot is not None \
            else num_slots - 1
        self.messages_processed = 0
        self.callback_entries = 0

    # -- protocol -------------------------------------------------------
    def submit(self, wd: WorkDescriptor, slot: int) -> None:
        raise NotImplementedError

    def complete(self, wd: WorkDescriptor, slot: int) -> None:
        raise NotImplementedError

    def idle_callback(self, worker_id: int) -> int:
        """An idle worker offers itself; returns messages processed."""
        return 0

    def callback(self, worker_id: int) -> int:
        """Dispatcher-facing name (historically DDASTManager.callback) —
        delegates so subclasses only ever override ``idle_callback``."""
        return self.idle_callback(worker_id)

    def drain_all(self) -> int:
        return 0

    def flush(self, slot: int) -> None:
        """Make the slot's buffered submits visible (batching policies)."""

    def notify_quiescent(self, root: bool = True,
                         scope_id: Optional[int] = None) -> None:
        """A taskwait on this policy reached quiescence; ``root`` marks
        the driver's top-level (root-task) taskwait — the boundary the
        record-and-replay wrapper freezes and validates recordings at.
        ``scope_id`` names the job scope whose root quiesced (None = the
        driver's own root context) — only the scope multiplexer
        (``core.scopes.ScopedPolicy``) routes on it; plain policies have
        no iteration state: no-op."""

    def pending(self) -> int:
        return 0

    def in_graph(self) -> int:
        raise NotImplementedError

    def stats(self) -> Dict[str, object]:
        raise NotImplementedError


def _blank_stats() -> Dict[str, object]:
    return {
        "messages_processed": 0,
        "lock_acquisitions": 0,
        "lock_wait_s": 0.0,
        "max_in_graph": 0,
        "total_edges": 0,
        "shard_messages": [],
        "shard_lock_wait_s": [],
        # delegation/combining (zero/empty outside the sharded policy)
        "delegated_portions": 0,
        "combined_drains": 0,
        "shard_lock_handoffs": [],
        "scope_portions": {},
    }


def _merge_shard_lists(carried, current):
    """Element-wise sum of two per-shard counter lists whose lengths may
    differ across a ``resize`` (shard i's meaning changes with the
    partition, but the element-wise sum keeps totals exact and per-slot
    attribution as close as the resize allows)."""
    if not carried:
        return list(current)
    n = max(len(carried), len(current))
    return [(carried[i] if i < len(carried) else 0)
            + (current[i] if i < len(current) else 0) for i in range(n)]


class _GlobalGraphMixin:
    """Per-parent ``DependenceGraph``s behind one global lock — shared by
    the three non-sharded policies."""

    def _init_graphs(self) -> None:
        self.graph_lock = InstrumentedLock()
        self._graphs: Dict[int, DependenceGraph] = {}

    def _graph_for(self, parent: WorkDescriptor) -> DependenceGraph:
        g = self._graphs.get(parent.wd_id)
        if g is None:
            g = self._graphs[parent.wd_id] = DependenceGraph()
        return g

    def _apply_submit(self, wd: WorkDescriptor) -> None:
        self.charge.submit_cs("graph", len(wd.deps))
        with self.graph_lock:
            ready = self._graph_for(wd.parent).submit(wd)
        if self.tracer.enabled:
            self.tracer.task_event(EV_DEPS, wd, -1)
        if ready:
            self.placement.push(wd)

    def _apply_done(self, wd: WorkDescriptor) -> None:
        self.charge.done_cs("graph", len(wd.deps))
        with self.graph_lock:
            newly = self._graph_for(wd.parent).complete(wd)
        for s in newly:
            self.placement.push(s)

    def in_graph(self) -> int:
        # list() snapshots atomically under the GIL; iterating the live
        # dict would race _graph_for's insert of a new parent's graph.
        return sum(g.in_graph for g in list(self._graphs.values()))

    def _graph_stats(self) -> Dict[str, object]:
        st = _blank_stats()
        st["lock_acquisitions"] = self.graph_lock.acquisitions
        st["lock_wait_s"] = self.graph_lock.wait_s
        for g in list(self._graphs.values()):
            st["max_in_graph"] = max(st["max_in_graph"], g.max_in_graph)
            st["total_edges"] += g.total_edges
        return st


class SyncPolicy(_GlobalGraphMixin, DependencePolicy):
    """Nanos++ baseline: every worker mutates the dependence graph
    directly under the global graph lock at submit & finish."""

    name = "sync"

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self._init_graphs()

    def submit(self, wd: WorkDescriptor, slot: int) -> None:
        self._apply_submit(wd)

    def complete(self, wd: WorkDescriptor, slot: int) -> None:
        self._apply_done(wd)

    def stats(self) -> Dict[str, object]:
        return self._graph_stats()


class _ManagedPolicy(DependencePolicy):
    """Shared Listing-2 manager machinery: the spin / MIN_READY_TASKS /
    MAX_OPS_THREAD drain loop and the MAX_DDAST_THREADS admission gate.
    Subclasses provide ``_drain_once`` (one pass over their queues or
    shards) and ``drain_all``."""

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self._active = 0
        self._active_lock = threading.Lock()

    def _drain_once(self, worker_id: int) -> int:
        raise NotImplementedError

    def idle_callback(self, worker_id: int) -> int:
        p = self.params
        eligible = self.manager_eligible
        if eligible is not None and worker_id != self.main_slot \
                and worker_id not in eligible:
            return 0                    # big.LITTLE: not a manager core
        max_threads = p.resolved_max_threads(self.num_workers)
        with self._active_lock:
            if self._active >= max_threads:
                return 0
            self._active += 1
        self.callback_entries += 1
        total = 0
        try:
            spins = p.max_spins
            while True:
                cnt = self._drain_once(worker_id)
                self.messages_processed += cnt
                total += cnt
                spins = (spins - 1) if cnt == 0 else p.max_spins
                if spins == 0 or \
                        self.placement.ready_count() >= p.min_ready_tasks:
                    break
        finally:
            with self._active_lock:
                self._active -= 1
        return total


class DdastPolicy(_GlobalGraphMixin, _ManagedPolicy):
    """This paper's organization: Submit/Done requests go to per-worker
    message queues; idle workers entering the callback become managers
    and drain them (Listing 2), updating the graph under the global
    lock with per-worker Submit-queue exclusivity (§3.1)."""

    name = "ddast"
    uses_idle_managers = True

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self._init_graphs()
        self.worker_queues: List[WorkerQueues] = [
            WorkerQueues(i) for i in range(self.num_slots)]
        # cumulative per-scope drained-message tally (combiner-free
        # analogue of the sharded router's scope_portions); int += under
        # the GIL, informational — folded into scope_rollup
        self.scope_drained: Dict[object, int] = {}
        # rotating first-served queue for _drain_once: a pass that stops
        # early (MIN_READY satisfied) must not always have served queue 0
        # first, or the tenant producing there owns readiness production
        # (unguarded += is a benign race — any start index is valid)
        self._drain_rr = 0

    # -- producer side --------------------------------------------------
    def submit(self, wd: WorkDescriptor, slot: int) -> None:
        self.charge.push()
        self.worker_queues[slot].submit.push(SubmitTaskMessage(wd))
        if self.tracer.enabled:
            self.tracer.task_event(EV_MSG_ENQ, wd, slot,
                                   data=("submit", slot, 1))

    def complete(self, wd: WorkDescriptor, slot: int) -> None:
        self.charge.push()
        self.worker_queues[slot].done.push(DoneTaskMessage(wd))
        if self.tracer.enabled:
            self.tracer.task_event(EV_MSG_ENQ, wd, slot,
                                   data=("done", slot, 1))

    # -- manager side ---------------------------------------------------
    def _drain_once(self, worker_id: int) -> int:
        """One pass over the per-worker queues (Listing 2 lines 6-15),
        with per-scope round-robin quanta: each scope gets at most
        ``params.drain_quantum`` messages analyzed per pass, so one
        tenant's submission flood cannot monopolize dependence analysis —
        its queue stops being drained for the rest of the pass while the
        other tenants' queues still get their turn. Per-queue FIFO is
        preserved: an over-quantum head is left *queued* (peeked, not
        popped), never skipped over. The pass starts at the queue where
        the previous pass stopped: MIN_READY stops most passes after one
        queue, so a fixed (or naively rotating) start lets the producer
        of a favored queue own readiness production — the continuation
        cursor makes first service a true round-robin over queues."""
        del worker_id
        p = self.params
        quantum = p.drain_quantum
        consumed: Dict[object, int] = {}
        total_cnt = 0
        qs = self.worker_queues
        nq = len(qs)
        start = self._drain_rr % nq
        self._drain_rr = start + 1      # full pass: rotate one anyway
        for k in range(nq):
            wq = qs[(start + k) % nq]
            if self.placement.ready_count() >= p.min_ready_tasks:
                # resume HERE next pass — this queue was not served
                self._drain_rr = start + k
                break
            cnt = 0
            if wq.acquire_submit():
                try:
                    while cnt < p.max_ops_thread:
                        nxt = wq.submit.peek()
                        if nxt is None:
                            break
                        if quantum and consumed.get(nxt.wd.scope,
                                                    0) >= quantum:
                            break       # scope exhausted its quantum:
                        #                 rotate to the next queue
                        msg = wq.submit.pop()
                        if msg is None:
                            break
                        sc = msg.wd.scope
                        consumed[sc] = consumed.get(sc, 0) + 1
                        self.scope_drained[sc] = \
                            self.scope_drained.get(sc, 0) + 1
                        self.charge.message()
                        if self.tracer.enabled:
                            self.tracer.task_event(
                                EV_MSG_DRAIN, msg.wd, -1,
                                data=("submit", wq.worker_id, 1))
                        self._apply_submit(msg.wd)
                        cnt += 1
                finally:
                    wq.release_submit()
            while cnt < p.max_ops_thread:
                # Done pops race across managers, so the peeked head may
                # not be the popped message — quantum accounting uses the
                # actual popped scope; the peek only decides rotation.
                nxt = wq.done.peek()
                if nxt is None:
                    break
                if quantum and consumed.get(nxt.wd.scope, 0) >= quantum:
                    break
                msg = wq.done.pop()
                if msg is None:
                    break
                sc = msg.wd.scope
                consumed[sc] = consumed.get(sc, 0) + 1
                self.scope_drained[sc] = self.scope_drained.get(sc, 0) + 1
                self.charge.message()
                if self.tracer.enabled:
                    self.tracer.task_event(EV_MSG_DRAIN, msg.wd, -1,
                                           data=("done", wq.worker_id, 1))
                self._apply_done(msg.wd)
                cnt += 1
            total_cnt += cnt
        return total_cnt

    def drain_all(self) -> int:
        """Drain every queue to empty (dast loop, taskwait/shutdown)."""
        n = 0
        progress = True
        while progress:
            progress = False
            for wq in self.worker_queues:
                if wq.acquire_submit():
                    try:
                        while True:
                            msg = wq.submit.pop()
                            if msg is None:
                                break
                            self.charge.message()
                            if self.tracer.enabled:
                                self.tracer.task_event(
                                    EV_MSG_DRAIN, msg.wd, -1,
                                    data=("submit", wq.worker_id, 1))
                            self._apply_submit(msg.wd)
                            n += 1
                            progress = True
                    finally:
                        wq.release_submit()
                while True:
                    msg = wq.done.pop()
                    if msg is None:
                        break
                    self.charge.message()
                    if self.tracer.enabled:
                        self.tracer.task_event(
                            EV_MSG_DRAIN, msg.wd, -1,
                            data=("done", wq.worker_id, 1))
                    self._apply_done(msg.wd)
                    n += 1
                    progress = True
        self.messages_processed += n
        return n

    def pending(self) -> int:
        return sum(wq.pending() for wq in self.worker_queues)

    def stats(self) -> Dict[str, object]:
        st = self._graph_stats()
        st["messages_processed"] = self.messages_processed
        return st

    def scope_drain_share(self, scope_id) -> int:
        """Cumulative messages drained on this tenant's behalf (see
        ``scope_drained``); surfaced through ``scope_rollup``."""
        return self.scope_drained.get(scope_id, 0)


class DastPolicy(DdastPolicy):
    """The authors' earlier centralized design [7]: same queues, but ONE
    dedicated manager thread (spawned by the driver) drains them; workers
    never manage."""

    name = "dast"
    needs_manager_thread = True
    uses_idle_managers = False
    idle_sleep_s = 1e-5


class ShardedPolicy(_ManagedPolicy):
    """Region-hash-partitioned manager (see ``core.shards``): per-shard
    graphs + mailboxes, idle workers claim whole shards. With
    ``batch_size`` set, a slot's Submits are buffered and shipped as
    :class:`~repro_torch.core.messages.SubmitBatchMessage`s — one mailbox entry
    (one ``msg_overhead``) per batch per shard — and its Dones are
    buffered symmetrically into per-slot done buffers shipped as
    :class:`~repro_torch.core.messages.DoneBatchMessage`s, flushed at the same
    points the submit buffers flush (capacity, taskwait ``flush``,
    ``drain_all``) plus whenever the owning slot goes idle (Dones, unlike
    Submits, gate successors' progress, so an idle owner must not sit on
    them)."""

    name = "sharded"
    uses_idle_managers = True

    def __init__(self, *args, num_shards: int = 4,
                 batch_size: Optional[int] = None,
                 delegation: bool = True, **kw) -> None:
        super().__init__(*args, **kw)
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if batch_size is not None and batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.num_shards = num_shards
        self.batch_size = batch_size
        self.delegation = delegation
        self.graph = ShardedDependenceGraph(num_shards)
        self.router = ShardRouter(self.graph,
                                  on_ready=self.placement.push,
                                  charge=self.charge,
                                  tracer=self.tracer,
                                  delegation=delegation,
                                  drain_quantum=self.params.drain_quantum)
        # Per-slot submit + done buffers. The owning slot appends; flush
        # may additionally be invoked by OTHER threads (drain_all at
        # taskwait/shutdown edges), so each buffer's read-swap and the
        # subsequent push_batch are serialized by a per-slot lock —
        # otherwise an append could land on an orphaned list and the WD
        # would never ship (its latches are already counted, so taskwait
        # would hang). push_batch stays inside the lock so two flushes
        # of one slot cannot interleave their mailbox entries, which
        # would break per-region FIFO order.
        self._buffers: List[List[WorkDescriptor]] = [
            [] for _ in range(self.num_slots)]
        self._done_buffers: List[List[WorkDescriptor]] = [
            [] for _ in range(self.num_slots)]
        self._buf_locks = [threading.Lock() for _ in range(self.num_slots)]
        # counters carried across resize() so stats stay cumulative
        self._carried = _blank_stats()

    # -- producer side --------------------------------------------------
    def submit(self, wd: WorkDescriptor, slot: int) -> None:
        if self.batch_size is None or self.batch_size <= 1:
            self.charge.push()
            self.router.route_submit(wd)
            return
        if self.router.prepare_submit(wd):
            self.charge.push()          # dependence-free: already ready;
            return                      # same producer cost as unbatched
        with self._buf_locks[slot]:
            buf = self._buffers[slot]
            buf.append(wd)
            if len(buf) >= self.batch_size:
                self._flush_submits_locked(slot)

    def flush(self, slot: int) -> None:
        with self._buf_locks[slot]:
            self._flush_submits_locked(slot)
            self._flush_dones_locked(slot)

    def _flush_submits_locked(self, slot: int) -> None:
        buf = self._buffers[slot]
        if not buf:
            return
        self._buffers[slot] = []
        self.charge.push()
        self.router.push_batch(buf)

    def _flush_dones_locked(self, slot: int) -> None:
        buf = self._done_buffers[slot]
        if not buf:
            return
        self._done_buffers[slot] = []
        self.charge.push()
        self.router.push_done_batch(buf)

    def complete(self, wd: WorkDescriptor, slot: int) -> None:
        # (Unbatched mode never buffers, so skip the per-completion lock
        # acquire entirely.)
        if self.batch_size is not None and self.batch_size > 1:
            with self._buf_locks[slot]:
                # A finished body can no longer extend its buffered
                # creations: flush them before the Done so
                # successors-by-batch can't be stranded behind an idle
                # worker.
                self._flush_submits_locked(slot)
                if wd.shard_parts:
                    # Done entries dominate high-shard-count mailbox
                    # traffic once Submits batch: buffer them the same
                    # way. Order vs. Submits is free either way — a
                    # Done processed before a later Submit just means
                    # the region was already scrubbed (the task IS
                    # completed), exactly the unbatched race.
                    buf = self._done_buffers[slot]
                    buf.append(wd)
                    if len(buf) >= self.batch_size:
                        self._flush_dones_locked(slot)
                    return
        # dependence-free tasks never entered any shard: route_done
        # completes them inline (no mailbox entry to batch)
        self.charge.push()
        self.router.route_done(wd)

    # -- manager side ---------------------------------------------------
    def idle_callback(self, worker_id: int) -> int:
        # An idle slot ships its own buffered Dones (and any buffered
        # Submits) when the ready pool has starved: a buffered Done
        # gates successor readiness, and nobody else flushes this slot
        # until a taskwait edge. While ready work remains anywhere the
        # buffer keeps filling toward a capacity flush (bigger batches);
        # the moment nothing is runnable, every idle worker flushes, so
        # progress can never stall on a buffered entry. Deliberately
        # BEFORE the manager admission gate — liveness must not depend
        # on winning a manager slot.
        if self.batch_size is not None and self.batch_size > 1 \
                and 0 <= worker_id < self.num_slots \
                and self.placement.ready_count() == 0:
            self.flush(worker_id)
        return super().idle_callback(worker_id)

    def _drain_once(self, worker_id: int) -> int:
        """One pass over the shard mailboxes: claim each free shard in
        turn (offset by worker id so concurrent managers spread out) and
        drain up to MAX_OPS_THREAD messages from it."""
        p = self.params
        router = self.router
        n = len(router.mailboxes)
        total_cnt = 0
        for off in range(n):
            if self.placement.ready_count() >= p.min_ready_tasks:
                break
            idx = (worker_id + off) % n
            # cheap peek before claiming: under delegation, published
            # portions live on the shard's request list, not the mailbox
            if router.mailboxes[idx].pending() == 0 \
                    and not self.graph.shards[idx].requests:
                continue
            total_cnt += router.drain_shard(idx, p.max_ops_thread)
        return total_cnt

    def drain_all(self) -> int:
        for slot in range(self.num_slots):
            self.flush(slot)
        n = self.router.drain_all()
        self.messages_processed += n
        return n

    def pending(self) -> int:
        return (self.router.pending()
                + sum(len(b) for b in self._buffers)
                + sum(len(b) for b in self._done_buffers))

    def in_graph(self) -> int:
        return self.graph.in_graph

    # -- online shard-count retuning ------------------------------------
    def resize(self, num_shards: int) -> bool:
        """Swap in a fresh ``num_shards``-way partition. Only legal at a
        quiescent point: nothing in any mailbox or buffer and nothing in
        the graph (``in_graph`` counts a task from Submit routing until
        its last Done portion, so zero also means nothing is running and
        nobody holds stale ``shard_parts``). Returns False when unsafe or
        a no-op; the caller (DynamicTuner) invokes this from the
        taskwait-quiescence hook on the main thread, the only thread that
        can start new work at that moment."""
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if num_shards == self.num_shards:
            return False
        if self.pending() or self.graph.in_graph:
            return False
        old = self.stats()
        for k in ("messages_processed", "lock_acquisitions", "lock_wait_s",
                  "total_edges", "delegated_portions", "combined_drains"):
            self._carried[k] = old[k]
        self._carried["max_in_graph"] = old["max_in_graph"]
        # per-shard counter lists survive the swap too — stats() already
        # merged any previously-carried lists into `old`, so carrying the
        # merged lists keeps them cumulative across repeated resizes
        self._carried["shard_messages"] = old["shard_messages"]
        self._carried["shard_lock_wait_s"] = old["shard_lock_wait_s"]
        self._carried["shard_lock_handoffs"] = old["shard_lock_handoffs"]
        self._carried["scope_portions"] = old["scope_portions"]
        self.num_shards = num_shards
        self.graph = ShardedDependenceGraph(num_shards)
        self.router = ShardRouter(self.graph,
                                  on_ready=self.placement.push,
                                  charge=self.charge,
                                  tracer=self.tracer,
                                  delegation=self.delegation,
                                  drain_quantum=self.params.drain_quantum)
        # shard-id-keyed affinity must follow the new partition function
        rekey = getattr(self.placement, "set_num_shards", None)
        if rekey is not None:
            rekey(num_shards)
        return True

    def stats(self) -> Dict[str, object]:
        c = self._carried
        st = _blank_stats()
        cur_msgs = [mb.messages_processed for mb in self.router.mailboxes]
        cur_waits = [s.lock.wait_s for s in self.graph.shards]
        st["shard_messages"] = _merge_shard_lists(c["shard_messages"],
                                                  cur_msgs)
        st["shard_lock_wait_s"] = _merge_shard_lists(c["shard_lock_wait_s"],
                                                     cur_waits)
        st["messages_processed"] = c["messages_processed"] + sum(cur_msgs)
        st["lock_acquisitions"] = c["lock_acquisitions"] + sum(
            s.lock.acquisitions for s in self.graph.shards)
        st["lock_wait_s"] = c["lock_wait_s"] + sum(cur_waits)
        st["max_in_graph"] = max(c["max_in_graph"],
                                 self.graph.max_in_graph)
        st["total_edges"] = c["total_edges"] + self.graph.total_edges
        # delegation/combining counters (zero in blocking-mailbox mode)
        st["delegated_portions"] = (c["delegated_portions"]
                                    + self.router.delegated_portions)
        st["combined_drains"] = (c["combined_drains"]
                                 + self.router.combined_drains)
        st["shard_lock_handoffs"] = _merge_shard_lists(
            c["shard_lock_handoffs"], self.router.lock_handoffs)
        merged: Dict[object, int] = dict(c["scope_portions"])
        for sc, k in self.router.scope_portions().items():
            merged[sc] = merged.get(sc, 0) + k
        st["scope_portions"] = merged
        return st

    def scope_drain_share(self, scope_id) -> int:
        """Cumulative dependence-analysis portions this tenant consumed
        through the combiners — folded into ``scope_rollup`` so per-tenant
        drain shares are visible alongside admission stats."""
        return self.stats()["scope_portions"].get(scope_id, 0)


_POLICIES = {
    "sync": SyncPolicy,
    "dast": DastPolicy,
    "ddast": DdastPolicy,
    "sharded": ShardedPolicy,
}

POLICY_NAMES = tuple(_POLICIES)


def mode_uses_shards(mode: str) -> bool:
    """True when ``mode`` resolves to a shard-partitioned policy — the
    only case a driver should switch shard-affine placement to shard-id
    affinity keying (outside it there is no shard partition to key by).
    Keeps that branching in the registry, not in the drivers."""
    if mode.startswith("replay:"):
        mode = mode[len("replay:"):]
    cls = _POLICIES.get(mode)
    return cls is not None and issubclass(cls, ShardedPolicy)


def mode_needs_manager_thread(mode: str) -> bool:
    """True when ``mode`` resolves to a policy that requires a dedicated
    manager (dast) — drivers use this for constructor-time validation
    (e.g. the simulator needs >= 2 cores for it) without per-mode
    branching of their own."""
    if mode.startswith("replay:"):
        mode = mode[len("replay:"):]
    try:
        cls = _POLICIES[mode]
    except KeyError:
        raise ValueError(f"mode must be one of {POLICY_NAMES}")
    return cls.needs_manager_thread


def make_policy(mode: str, num_slots: int, replay: bool = False,
                **kw) -> DependencePolicy:
    """Build the policy for ``mode``. ``num_shards``/``batch_size``/
    ``delegation`` are accepted for every mode and silently dropped where
    meaningless, so drivers stay free of per-mode branching. With ``replay=True`` (or a
    ``"replay:<mode>"`` mode string) the policy is wrapped in a
    :class:`~repro_torch.core.engine.replay.ReplayPolicy`, which records the
    first iteration's task structure through the live policy and elides
    dependence analysis on structurally identical re-submissions."""
    if mode.startswith("replay:"):
        replay = True
        mode = mode[len("replay:"):]
    try:
        cls = _POLICIES[mode]
    except KeyError:
        raise ValueError(f"mode must be one of {POLICY_NAMES}")
    if not issubclass(cls, ShardedPolicy):
        kw.pop("num_shards", None)
        kw.pop("batch_size", None)
        kw.pop("delegation", None)
    pol = cls(num_slots, **kw)
    if replay:
        from .replay import ReplayPolicy
        pol = ReplayPolicy(pol)
    return pol
