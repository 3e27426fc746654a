"""Copy of `repro/core/trace/recorder.py`.

Per-task event tracing: append-only ring buffers, one per worker slot.

The paper argues about *where time goes inside the runtime* — manager
queue residency, lock waits, idle drains — and "Detrimental task
execution patterns" (PAPERS.md, 2406.03077) shows per-task lifecycle
timelines are enough to detect the pathologies automatically. This
module is the recording layer both drivers share:

  * task lifecycle:  ``created`` → ``deps_resolved`` → ``ready`` →
    ``start`` → ``end`` (stamped by whichever layer owns the
    transition: driver, dependence policy, placement);
  * manager side:    ``msg_enqueued`` / ``msg_drained`` (per-worker
    queues and shard mailboxes), ``steal`` (a ready task left another
    slot's deque), ``admission_defer`` (FairAdmission held a tenant's
    task in its ring);
  * boundaries:      ``quiesce`` at every root-taskwait quiescence,
    carrying the replay iteration count so consumers can tell live
    windows (manager events present) from replayed ones (elided by
    design).

Design constraints, in order:

1. **No new locks on the hot path.** Each slot appends to its own
   ``collections.deque(maxlen=capacity)`` — append is GIL-atomic and
   O(1), and a bounded deque drops from the head, so a run that
   outlives the capacity loses the *oldest* events per slot and nothing
   blocks. Producers that act on behalf of no particular slot
   (managers draining another worker's queue, the sharded router) use
   one shared overflow ring; deque append atomicity makes that safe
   too.
2. **Disabled cost = one attribute check.** Every call site guards with
   ``if tracer.enabled:``; ``NULL_TRACER`` answers ``enabled = False``
   and no-ops everything, so ``trace=False`` runs never construct an
   event tuple.
3. **One schema for both drivers.** Events are plain tuples
   ``(t, ev, wd_id, slot, label, scope, data)``; the clock is a
   callable — ``time.perf_counter()`` relative to run start under
   threads, ``SimCharger.now`` (virtual µs) under the simulator. The
   simulator additionally prices each stamp (``SimCosts.trace_event``)
   through the charger so the traced-vs-untraced overhead gate in
   ``bench_traces.py`` measures a real cost, not zero by construction.
"""
from __future__ import annotations

import json
from collections import deque
from typing import (Any, Callable, List, NamedTuple, Optional, Tuple)

# -- event kinds (string constants so traces stay greppable) -----------
EV_CREATED = "created"            # WD allocated + submitted by a worker
EV_DEPS = "deps_resolved"         # dependence analysis applied (per
#                                   shard portion in sharded mode)
EV_READY = "ready"                # pushed into a slot's ready deque;
#                                   slot = target deque; data: "affine"
#                                   or ("band", b) when applicable
EV_START = "start"                # body started on slot
EV_END = "end"                    # body finished on slot
EV_MSG_ENQ = "msg_enqueued"       # Submit/Done posted to a queue/mailbox
EV_MSG_DRAIN = "msg_drained"      # a manager processed one entry
EV_DELEGATE = "delegated"         # Submit/Done portion published to a
#                                   shard's MPSC request list (the
#                                   delegation analogue of msg_enqueued;
#                                   same (kind, shard, n) payload)
EV_COMBINE = "combined"           # one combine session: the lock holder
#                                   applied n published portions in a
#                                   single combined critical section
EV_STEAL = "steal"                # popped from another slot's deque;
#                                   slot = thief, data = victim slot
EV_ADMIT_DEFER = "admission_defer"  # FairAdmission held the task back
EV_QUIESCE = "quiesce"            # root-taskwait quiescence boundary

# -- fault-tolerance events (core.errors; process-backend supervisor
#    and the threaded retry path) ---------------------------------------
EV_WORKER_LOST = "worker_lost"    # a worker process died; data: pid,
#                                   exitcode, in-flight task labels
EV_RESPAWN = "respawn"            # supervisor replaced the worker;
#                                   slot = the respawned worker's slot
EV_RETRY = "retry"                # a task was re-dispatched after a
#                                   fault; data: attempt no. + reason
EV_TIMEOUT_KILL = "timeout_kill"  # per-task timeout expired: the stuck
#                                   worker was killed
EV_SCOPE_EXPIRED = "scope_expired"  # a scope's deadline/budget ran out;
#                                   its unrun tasks drain-and-fail
EV_TRACE_LOST = "trace_lost"      # a crashed worker's in-flight task
#                                   events could not be reconstructed

TASK_LIFECYCLE = (EV_CREATED, EV_DEPS, EV_READY, EV_START, EV_END)
FAULT_EVENTS = (EV_WORKER_LOST, EV_RESPAWN, EV_RETRY, EV_TIMEOUT_KILL,
                EV_SCOPE_EXPIRED, EV_TRACE_LOST)


class TraceEvent(NamedTuple):
    t: float                      # clock units (s threaded, µs sim)
    ev: str
    wd_id: int                    # -1 for manager/boundary events
    slot: int                     # acting slot; -1 when unattributed
    label: str
    scope: Optional[int]
    data: Any                     # event-specific payload (JSON-able)


class NullTraceRecorder:
    """The ``trace=False`` stub: every producer guards on ``.enabled``,
    so these bodies exist only for callers that skip the guard."""

    enabled = False

    def task_event(self, ev, wd, slot, data=None) -> None:
        pass

    def mgr_event(self, ev, slot, data=None) -> None:
        pass

    def quiesce(self, data=None) -> None:
        pass

    def ingest(self, events) -> None:
        pass

    def events(self) -> List[TraceEvent]:
        return []

    @property
    def dropped(self) -> int:
        return 0

    @property
    def total_appended(self) -> int:
        return 0


NULL_TRACER = NullTraceRecorder()


class TraceRecorder:
    """Per-slot bounded ring buffers + merge/save. One instance per run."""

    enabled = True

    def __init__(self, num_slots: int, clock: Callable[[], float],
                 capacity: int = 1 << 16, charge=None,
                 time_unit: str = "s") -> None:
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.num_slots = num_slots
        self.clock = clock
        self.capacity = capacity
        self.time_unit = time_unit          # "s" (threads) | "us" (sim)
        # priced stamps under the simulator; None under real threads
        self._charge = charge
        # rings[slot] for attributed producers, rings[-1] shared overflow
        self._rings: List[deque] = [deque(maxlen=capacity)
                                    for _ in range(num_slots + 1)]
        self._appended = [0] * (num_slots + 1)

    # -- producers (hot path: one append, no lock) ---------------------
    def _emit(self, slot: int, tup: Tuple) -> None:
        i = slot if 0 <= slot < self.num_slots else self.num_slots
        self._rings[i].append(tup)
        self._appended[i] += 1

    def task_event(self, ev: str, wd, slot: int, data=None) -> None:
        if self._charge is not None:
            self._charge.trace_event()
        self._emit(slot, (self.clock(), ev, wd.wd_id, slot, wd.label,
                          wd.scope, data))

    def mgr_event(self, ev: str, slot: int, data=None) -> None:
        if self._charge is not None:
            self._charge.trace_event()
        self._emit(slot, (self.clock(), ev, -1, slot, "", None, data))

    def quiesce(self, data=None) -> None:
        self.mgr_event(EV_QUIESCE, -1, data)

    def ingest(self, events) -> None:
        """Merge pre-stamped tuples recorded in another process (the
        process backend's per-worker rings, shipped at shutdown, and its
        replay-plane start/end stamps). Tuples must already be in the
        standard 7-field schema on this recorder's clock; the slot is
        read from the tuple, so worker events land in their own rings
        and the usual overflow accounting applies."""
        for e in events:
            self._emit(e[3], tuple(e))

    # -- consumers (cold path) -----------------------------------------
    @property
    def dropped(self) -> int:
        """Events evicted by ring overflow (oldest-first, per slot)."""
        return sum(self._appended) - sum(len(r) for r in self._rings)

    @property
    def total_appended(self) -> int:
        """Lifetime append count — a cheap has-anything-new probe for
        periodic consumers (the tuner's quiescence hook)."""
        return sum(self._appended)

    def events(self) -> List[TraceEvent]:
        """All retained events, merged and time-sorted. The sort is
        stable, so same-timestamp events keep per-ring append order.

        Each ring is copied by one C-level ``tuple()`` call, which holds
        the GIL throughout: the metrics sampler reads the rings while
        producers append, and iterating a ring in bytecode there raised
        "deque mutated during iteration" on a worker thread (the JAX
        package's copy iterates the live ring)."""
        evs = [TraceEvent(*e) for ring in self._rings for e in tuple(ring)]
        evs.sort(key=lambda e: e.t)
        return evs

    def save(self, path: str) -> None:
        save_trace(path, self.events(), time_unit=self.time_unit,
                   num_slots=self.num_slots, dropped=self.dropped)


def save_trace(path: str, events, time_unit: str = "s",
               num_slots: int = 0, dropped: int = 0) -> None:
    """Write an event list in :meth:`TraceRecorder.save` format — for
    results that carry merged events but no recorder (``SimResult``,
    a post-shutdown ``RuntimeStats``)."""
    if not num_slots:
        num_slots = max((e[3] for e in events), default=0) + 1
    with open(path, "w") as f:
        json.dump({"time_unit": time_unit,
                   "num_slots": num_slots,
                   "dropped": dropped,
                   "events": [list(e) for e in events]}, f)


def load_trace(path: str) -> Tuple[List[TraceEvent], dict]:
    """Load a :meth:`TraceRecorder.save` file. Tuple payloads round-trip
    as lists; consumers index ``data`` rather than type-check it."""
    with open(path) as f:
        doc = json.load(f)
    events = [TraceEvent(*e) for e in doc["events"]]
    meta = {k: doc.get(k) for k in ("time_unit", "num_slots", "dropped")}
    return events, meta


def replay_iterations_of(policy, scope_id=None) -> int:
    """The replay iteration count the ``quiesce`` event should carry:
    resolved through the scope multiplexer when one is present, 0 for
    policies with no replay wrapper. Shared by both drivers so the
    boundary payloads are identical."""
    resolve = getattr(policy, "scope_policy", None)
    if resolve is not None:
        policy = resolve(scope_id)      # None -> the default root slot
    return getattr(policy, "replay_iterations", 0)
