"""Copy of `repro/core/shards/router.py`.

Shard router: per-shard delegation/combining + the cross-shard join
protocol.

Message flow in ``sharded`` mode (compare Fig. 3 of the paper, where the
mailboxes are per *worker*). With delegation (the default), every
Submit/Done portion goes through a flat-combining publication protocol:

    worker creates/finishes task ──publish──▶ ``GraphShard.requests``
        (GIL-atomic MPSC append), then TRYLOCK the shard lock:
          * trylock fails  → return immediately (wait-free): the current
            holder — the **combiner** — applies the published portion
            before or right after releasing;
          * trylock wins   → become the combiner: drain the request list
            and apply every published portion (own + delegated) in one
            combined critical section, in per-scope round-robin quanta.

A combiner that releases re-checks the request list: a producer that
published *during* the release window already failed its trylock and
returned, so the releasing holder takes the lock back rather than
strand the portion. With ``delegation=False`` the pre-existing blocking
transport is used: per-shard mailboxes drained under a claim flag, each
message applied under a blocking ``with shard.lock`` acquisition — the
baseline the contention benchmark compares against.

Either way, exactly one thread mutates a given shard at a time, and
portions published by one producer are applied in publication order
(deque FIFO + in-order combine), so per-(parent, region) submission
order — the §3.1 invariant the dependence rules require — is preserved
per shard, while different shards proceed fully in parallel. Portions
of *different* scopes may be interleaved by the fairness rotation;
that is sound because scoped dependence namespaces never share a
(parent, region) key.

Join protocol for a task whose deps span k shards:

  * ``prepare_submit`` sets ``wd.shard_pending = k`` (the submit latch)
    and ``wd.shard_done = k`` (the completion latch); ``route_submit``
    then posts one SubmitTaskMessage per shard (or the ShardedPolicy
    buffers the WD and later posts one ``SubmitBatchMessage`` per shard
    per batch). k == 0 (no deps) short-circuits to ready.
  * each shard's Submit processing atomically adds
    ``local_pred_edges - 1``; the unique update that reaches 0 marks the
    task ready (all shards inserted, no unsatisfied edge).
  * each shard's Done processing subtracts 1 per satisfied edge of each
    local successor, and subtracts 1 from the finished task's
    ``shard_done``; the unique update reaching 0 completes the WD
    (parent bookkeeping, graph occupancy).

A predecessor recorded via two regions on two different shards yields
two edges and, symmetrically, two decrements — counts balance, so the
deduplication the single graph performs globally is only needed (and
done) within each shard.

Every graph action is priced through the router's
:class:`~repro_torch.core.engine.charge.CostCharger` — a no-op under real
threads, a virtual-time clock under the simulator — so both drivers
share this exact code path.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional, Union

from ..messages import (DoneBatchMessage, DoneTaskMessage,
                        SubmitBatchMessage, SubmitTaskMessage)
from ..trace import (EV_COMBINE, EV_DELEGATE, EV_DEPS, EV_MSG_DRAIN,
                     EV_MSG_ENQ, NULL_TRACER)
from ..wd import TaskState, WorkDescriptor
from .sharded_graph import ShardedDependenceGraph, partition_deps
from .steal_deque import AtomicCounter

_Message = Union[SubmitTaskMessage, SubmitBatchMessage, DoneTaskMessage,
                 DoneBatchMessage]


class ShardMailbox:
    """MPSC FIFO message queue of one shard: every worker thread pushes
    (CPython deque.append is atomic under the GIL), one draining manager
    at a time pops (claim flag). Deliberately NOT an SPSCQueue — that
    class's contract and counters assume a single producer."""

    __slots__ = ("index", "_q", "_drain_flag", "messages_processed")

    def __init__(self, index: int) -> None:
        self.index = index
        self._q: deque = deque()
        self._drain_flag = threading.Lock()
        # only the claiming manager mutates this, so a plain int is safe
        self.messages_processed = 0

    def push(self, msg: "_Message") -> None:
        self._q.append(msg)

    def pop(self) -> Optional["_Message"]:
        try:
            return self._q.popleft()
        except IndexError:
            return None

    def try_claim(self) -> bool:
        return self._drain_flag.acquire(blocking=False)

    def release(self) -> None:
        self._drain_flag.release()

    def pending(self) -> int:
        return len(self._q)


class ShardRouter:
    """Routes Submit/Done to shard mailboxes and applies the join
    protocol when managers process them."""

    def __init__(self, graph: ShardedDependenceGraph,
                 on_ready: Callable[[WorkDescriptor], None],
                 charge=None, tracer=None, delegation: bool = True,
                 drain_quantum: int = 16) -> None:
        from ..engine.charge import CostCharger
        self.graph = graph
        self.on_ready = on_ready
        self.charge = charge if charge is not None else CostCharger()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        #: delegation/combining transport (module docstring); False =
        #: the blocking mailbox baseline.
        self.delegation = delegation
        #: max portions one scope's bucket contributes per rotation pass
        #: of a combine session (DDASTParams.drain_quantum upstream);
        #: 0 disables the quantum — pure FIFO drain order, matching the
        #: ddast queue sweep's reading of the same knob.
        self.drain_quantum = max(0, drain_quantum)
        self.mailboxes: List[ShardMailbox] = [
            ShardMailbox(i) for i in range(graph.num_shards)]

    # -- producer side (any worker thread) -----------------------------
    def prepare_submit(self, wd: WorkDescriptor) -> bool:
        """Partition the deps once (shards read ``wd.shard_parts`` on the
        hot path instead of re-hashing regions under their lock),
        initialize both join latches, and record graph occupancy. Both
        latches MUST be set before the first message is visible to a
        manager. Returns True for a dependence-free task, which is made
        ready immediately and needs no Submit messages."""
        parts = partition_deps(wd, self.graph.num_shards)
        wd.shard_parts = parts
        k = len(parts)
        wd.shard_pending = AtomicCounter(k)
        wd.shard_done = AtomicCounter(k)
        wd.state = TaskState.SUBMITTED
        self.graph.task_entered()
        if k == 0:                       # dependence-free: ready now
            wd.mark_ready()
            self.on_ready(wd)
            return True
        return False

    def _publish(self, s: int, msg: "_Message", kind: str, n: int) -> None:
        """Transport one message to shard ``s``. Delegation: append to
        the shard's MPSC publication list (GIL-atomic), then compete for
        the combiner role — losing the trylock is the wait-free return.
        Blocking baseline: the claim-flagged mailbox."""
        tr = self.tracer
        if not self.delegation:
            self.mailboxes[s].push(msg)
            if tr.enabled:
                tr.mgr_event(EV_MSG_ENQ, -1, data=(kind, s, n))
            return
        self.graph.shards[s].requests.append(msg)
        self.charge.delegate()
        if tr.enabled:
            tr.mgr_event(EV_DELEGATE, -1, data=(kind, s, n))
        self._try_combine(s)

    def route_submit(self, wd: WorkDescriptor) -> None:
        if self.prepare_submit(wd):
            return
        msg = SubmitTaskMessage(wd)
        for s in wd.shard_parts:
            self._publish(s, msg, "submit", 1)

    def push_batch(self, wds: List[WorkDescriptor]) -> None:
        """Ship already-prepared WDs (see ``prepare_submit``) as one
        SubmitBatchMessage per shard touched by the batch, preserving the
        producer's creation order within each entry."""
        per_shard = {}
        for wd in wds:
            for s in wd.shard_parts:
                per_shard.setdefault(s, []).append(wd)
        for s, group in per_shard.items():
            self._publish(s, SubmitBatchMessage(group), "submit_batch",
                          len(group))

    def route_done(self, wd: WorkDescriptor) -> None:
        parts = wd.shard_parts            # cached by prepare_submit
        if not parts:                     # never entered any shard
            self.graph.task_left()
            wd.mark_completed()
            return
        msg = DoneTaskMessage(wd)
        for s in parts:
            self._publish(s, msg, "done", 1)

    def push_done_batch(self, wds: List[WorkDescriptor]) -> None:
        """Ship finished WDs (each with at least one shard portion) as
        one DoneBatchMessage per shard touched by the batch — the Done
        analogue of ``push_batch``."""
        per_shard = {}
        for wd in wds:
            for s in wd.shard_parts:
                per_shard.setdefault(s, []).append(wd)
        for s, group in per_shard.items():
            self._publish(s, DoneBatchMessage(group), "done_batch",
                          len(group))

    # -- consumer side (the claiming manager) --------------------------
    def _submit_local(self, shard, wd: WorkDescriptor) -> bool:
        """Insert one shard portion; returns True if the join latch hit
        zero (caller marks ready). Must hold ``shard.lock``."""
        local_preds = shard.submit_local(wd)
        # +local edges, -1 for this shard's latch unit
        return wd.shard_pending.add(local_preds - 1) == 0

    def process(self, shard_index: int, msg: _Message) -> None:
        """Apply one mailbox entry to one shard. Caller must hold the
        shard's mailbox claim (single manager per shard)."""
        shard = self.graph.shards[shard_index]
        self.charge.message()
        tr = self.tracer
        if tr.enabled:
            n = len(msg.wds) if type(msg) in (SubmitBatchMessage,
                                              DoneBatchMessage) else 1
            kind = ("submit" if type(msg) in (SubmitTaskMessage,
                                              SubmitBatchMessage)
                    else "done")
            tr.mgr_event(EV_MSG_DRAIN, -1, data=(kind, shard_index, n))
        if type(msg) is SubmitBatchMessage:
            self.charge.submit_batch_cs(
                ("shard", shard_index),
                [(len(wd.shard_parts[shard_index]), len(wd.shard_parts))
                 for wd in msg.wds])
            newly = []
            with shard.lock:
                for wd in msg.wds:
                    if self._submit_local(shard, wd):
                        newly.append(wd)
            if tr.enabled:
                # one deps_resolved per shard portion; consumers use
                # the LAST one per task (the latch-zero portion)
                for wd in msg.wds:
                    tr.task_event(EV_DEPS, wd, -1, data=shard_index)
            for wd in newly:
                wd.mark_ready()
                self.on_ready(wd)
        elif type(msg) is SubmitTaskMessage:
            wd = msg.wd
            self.charge.submit_portion_cs(
                ("shard", shard_index),
                len(wd.shard_parts[shard_index]), len(wd.shard_parts))
            with shard.lock:
                ready = self._submit_local(shard, wd)
            if tr.enabled:
                tr.task_event(EV_DEPS, wd, -1, data=shard_index)
            if ready:
                wd.mark_ready()
                self.on_ready(wd)
        elif type(msg) is DoneBatchMessage:
            self.charge.done_batch_cs(
                ("shard", shard_index),
                [(len(wd.shard_parts[shard_index]), len(wd.shard_parts))
                 for wd in msg.wds])
            all_succs = []
            with shard.lock:
                for wd in msg.wds:
                    all_succs.append(shard.complete_local(wd))
            for wd, succs in zip(msg.wds, all_succs):
                self._finish_done(wd, succs)
        else:
            wd = msg.wd
            self.charge.done_portion_cs(
                ("shard", shard_index),
                len(wd.shard_parts[shard_index]), len(wd.shard_parts))
            with shard.lock:
                succs = shard.complete_local(wd)
            self._finish_done(wd, succs)
        self.mailboxes[shard_index].messages_processed += 1

    # -- delegation/combining (consumer side) --------------------------
    @staticmethod
    def _split_scopes(msg: "_Message"):
        """Split one published message into ``(scope, message)`` pieces,
        each single-scope, preserving intra-message order. Single-task
        messages and single-scope batches (the common case: per-slot
        batch buffers usually fill within one tenant's burst) pass
        through untouched. A mixed-scope batch becomes one sub-batch per
        same-scope *run*, so every portion lands in its own scope's
        fairness bucket: bucketing a whole mixed batch under one scope
        would let the rotation apply its other-scope tail ahead of that
        scope's earlier, still-bucketed messages — reordering same-scope
        same-(parent, region) Submits and breaking the §3.1 invariant."""
        t = type(msg)
        if t in (SubmitBatchMessage, DoneBatchMessage):
            wds = msg.wds
            first = wds[0].scope
            if all(wd.scope == first for wd in wds):
                return ((first, msg),)
            out = []
            run = [wds[0]]
            cur = first
            for wd in wds[1:]:
                if wd.scope == cur:
                    run.append(wd)
                else:
                    out.append((cur, t(run)))
                    run = [wd]
                    cur = wd.scope
            out.append((cur, t(run)))
            return out
        return ((msg.wd.scope, msg),)

    def _try_combine(self, shard_index: int) -> int:
        """Compete for the combiner role on one shard. The caller's
        portion (if any) is already published, so losing the trylock IS
        the wait-free path: the current holder applies it. Returns
        portions applied by THIS thread."""
        shard = self.graph.shards[shard_index]
        applied = 0
        first = True
        while shard.requests:
            if not shard.lock.try_acquire():
                # someone else holds the shard: they re-check the
                # request list before abandoning the lock (below), so
                # every published portion is applied by somebody
                return applied
            if not first:
                shard.handoffs += 1
            try:
                applied += self._combine_locked(shard_index, shard)
            finally:
                shard.lock.release()
            first = False
            # post-release re-check: a producer that published after our
            # final drain already failed its trylock and returned — loop
            # and take the lock back rather than strand its portion.
        return applied

    def _combine_locked(self, shard_index: int, shard) -> int:
        """One combine session (``shard.lock`` held): stage every
        published request into per-scope buckets (mixed-scope batches
        split into single-scope runs first, see ``_split_scopes``), then
        apply them in round-robin quanta of ``drain_quantum`` portions
        per scope per pass — one tenant's flood cannot monopolize this
        shard's dependence analysis. Within a scope, publication (FIFO)
        order is preserved, which is what carries the §3.1 per-producer
        ordering invariant through the combiner. ``drain_quantum == 0``
        disables the rotation entirely: requests are applied in pure
        publication-FIFO order."""
        reqs = shard.requests
        if not reqs:
            return 0
        self.charge.combine()
        applied = 0
        quantum = self.drain_quantum
        share = shard.scope_portions
        if quantum == 0:
            # quantum disabled: pure FIFO drain, no staging pass
            while True:
                try:
                    msg = reqs.popleft()
                except IndexError:  # producers only append; safe bound
                    break
                for sc, piece in self._split_scopes(msg):
                    n = self._apply(shard_index, shard, piece)
                    applied += n
                    share[sc] = share.get(sc, 0) + n
        else:
            buckets: dict = {}
            order: list = []
            while True:
                try:
                    msg = reqs.popleft()
                except IndexError:  # producers only append; safe bound
                    break
                for sc, piece in self._split_scopes(msg):
                    b = buckets.get(sc)
                    if b is None:
                        b = buckets[sc] = deque()
                        order.append(sc)
                    b.append(piece)
            while order:
                for sc in list(order):
                    b = buckets[sc]
                    used = 0
                    while b and used < quantum:
                        n = self._apply(shard_index, shard, b.popleft())
                        used += n
                    if used:
                        applied += used
                        share[sc] = share.get(sc, 0) + used
                    if not b:
                        del buckets[sc]
                        order.remove(sc)
        if applied:
            shard.delegated += applied
            shard.combined += 1
            tr = self.tracer
            if tr.enabled:
                tr.mgr_event(EV_COMBINE, -1,
                             data=("combine", shard_index, applied))
        return applied

    def _apply(self, shard_index: int, shard, msg: "_Message") -> int:
        """Apply one published message under the combiner's already-held
        shard lock; returns the number of shard portions it carried.
        Mirrors :meth:`process` minus the per-message lock acquisition —
        that is the whole point of combining."""
        self.charge.message()
        tr = self.tracer
        if type(msg) is SubmitBatchMessage:
            n = len(msg.wds)
            if tr.enabled:
                tr.mgr_event(EV_MSG_DRAIN, -1,
                             data=("submit", shard_index, n))
            self.charge.submit_batch_cs(
                ("shard", shard_index),
                [(len(wd.shard_parts[shard_index]), len(wd.shard_parts))
                 for wd in msg.wds])
            newly = []
            for wd in msg.wds:
                if self._submit_local(shard, wd):
                    newly.append(wd)
            if tr.enabled:
                for wd in msg.wds:
                    tr.task_event(EV_DEPS, wd, -1, data=shard_index)
            for wd in newly:
                wd.mark_ready()
                self.on_ready(wd)
        elif type(msg) is SubmitTaskMessage:
            n = 1
            wd = msg.wd
            if tr.enabled:
                tr.mgr_event(EV_MSG_DRAIN, -1,
                             data=("submit", shard_index, 1))
            self.charge.submit_portion_cs(
                ("shard", shard_index),
                len(wd.shard_parts[shard_index]), len(wd.shard_parts))
            ready = self._submit_local(shard, wd)
            if tr.enabled:
                tr.task_event(EV_DEPS, wd, -1, data=shard_index)
            if ready:
                wd.mark_ready()
                self.on_ready(wd)
        elif type(msg) is DoneBatchMessage:
            n = len(msg.wds)
            if tr.enabled:
                tr.mgr_event(EV_MSG_DRAIN, -1,
                             data=("done", shard_index, n))
            self.charge.done_batch_cs(
                ("shard", shard_index),
                [(len(wd.shard_parts[shard_index]), len(wd.shard_parts))
                 for wd in msg.wds])
            for wd in msg.wds:
                succs = shard.complete_local(wd)
                self._finish_done(wd, succs)
        else:
            n = 1
            wd = msg.wd
            if tr.enabled:
                tr.mgr_event(EV_MSG_DRAIN, -1,
                             data=("done", shard_index, 1))
            self.charge.done_portion_cs(
                ("shard", shard_index),
                len(wd.shard_parts[shard_index]), len(wd.shard_parts))
            succs = shard.complete_local(wd)
            self._finish_done(wd, succs)
        self.mailboxes[shard_index].messages_processed += 1
        return n

    def _finish_done(self, wd: WorkDescriptor,
                     succs: List[WorkDescriptor]) -> None:
        """Latch arithmetic after one shard scrubbed its Done portion of
        ``wd``: satisfy local successor edges, then retire the portion."""
        for s in succs:
            if s.shard_pending.add(-1) == 0:
                s.mark_ready()
                self.on_ready(s)
        if wd.shard_done.add(-1) == 0:
            self.graph.task_left()
            wd.mark_completed()

    def drain_shard(self, shard_index: int, max_ops: int) -> int:
        """Idle-manager drain of one shard. Delegation: become the
        combiner if the lock is free (a combine session applies every
        published portion — ``max_ops`` does not bound it; bounding
        would just strand requests for the next pass). Blocking: claim
        the mailbox and process up to ``max_ops`` entries. Returns 0 if
        another thread already owns the shard."""
        if self.delegation:
            return self._try_combine(shard_index)
        mb = self.mailboxes[shard_index]
        if not mb.try_claim():
            return 0
        cnt = 0
        try:
            while cnt < max_ops:
                msg = mb.pop()
                if msg is None:
                    break
                self.process(shard_index, msg)
                cnt += 1
        finally:
            mb.release()
        return cnt

    def drain_all(self) -> int:
        """Drain every shard to empty (taskwait/shutdown edges). Like
        the blocking variant, loops only while THIS thread progresses:
        requests held by a concurrent combiner are its to apply, and the
        caller's quiescence loop re-polls ``pending()``."""
        if self.delegation:
            n = 0
            progress = True
            while progress:
                progress = False
                for i, shard in enumerate(self.graph.shards):
                    if shard.requests:
                        c = self._try_combine(i)
                        if c:
                            n += c
                            progress = True
            return n
        n = 0
        progress = True
        while progress:
            progress = False
            for mb in self.mailboxes:
                if not mb.try_claim():
                    continue
                try:
                    while True:
                        msg = mb.pop()
                        if msg is None:
                            break
                        self.process(mb.index, msg)
                        n += 1
                        progress = True
                finally:
                    mb.release()
        return n

    def pending(self) -> int:
        return (sum(mb.pending() for mb in self.mailboxes)
                + sum(len(s.requests) for s in self.graph.shards))

    @property
    def messages_processed(self) -> int:
        return sum(mb.messages_processed for mb in self.mailboxes)

    # -- delegation counters (combiner-maintained, see GraphShard) -----
    @property
    def delegated_portions(self) -> int:
        return sum(s.delegated for s in self.graph.shards)

    @property
    def combined_drains(self) -> int:
        return sum(s.combined for s in self.graph.shards)

    @property
    def lock_handoffs(self) -> List[int]:
        return [s.handoffs for s in self.graph.shards]

    def scope_portions(self) -> dict:
        """scope -> portions applied for that tenant, summed over
        shards (None = the scope-less root context)."""
        out: dict = {}
        for s in self.graph.shards:
            for sc, n in s.scope_portions.items():
                out[sc] = out.get(sc, 0) + n
        return out
