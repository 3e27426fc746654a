"""Copy of `repro/core/wd.py`.

Work Descriptor (WD) — task representation, mirroring Nanos++ (paper §2.2.1).

Each task is one WD carrying everything needed across its life cycle:
creation -> submission -> ready -> (blocked) -> finished -> completed -> deleted.

The paper replaces a third "delete" message with an extra task state
(§3.1): a WD whose Done Task Message has not yet been handled is in state
FINISHED; once a manager processes the message it moves to COMPLETED and
only then may be deleted (DELETED).
"""
from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Tuple

_wd_ids = itertools.count()


class DepMode(enum.Enum):
    IN = "in"
    OUT = "out"
    INOUT = "inout"

    @property
    def reads(self) -> bool:
        return self in (DepMode.IN, DepMode.INOUT)

    @property
    def writes(self) -> bool:
        return self in (DepMode.OUT, DepMode.INOUT)


class TaskState(enum.Enum):
    CREATED = 0      # WD allocated, args captured
    SUBMITTED = 1    # handed to the runtime, in (or queued for) the dep graph
    READY = 2        # all predecessors satisfied, in the ready pool
    RUNNING = 3      # executing on a worker
    BLOCKED = 4      # taskwait: waiting for children
    FINISHED = 5     # body done; Done Task Message not yet handled
    COMPLETED = 6    # Done message handled; graph updated; safe to delete
    DELETED = 7


@dataclass(eq=False)
class WorkDescriptor:
    """One task. `deps` is a sequence of (region, mode); regions are any
    hashable key (the block-id analogue of an OmpSs memory region)."""

    func: Optional[Callable[..., Any]]
    args: Tuple[Any, ...] = ()
    deps: Sequence[Tuple[Any, DepMode]] = ()
    label: str = "task"
    parent: Optional["WorkDescriptor"] = None
    duration: Optional[float] = None  # virtual duration for the simulator
    # Measured body execution time (seconds), stamped by the threaded
    # driver — feeds the replay scheduler's per-task cost EMA (the
    # simulator uses `duration` for the same purpose).
    exec_dur: Optional[float] = None
    # Multi-tenant job-scope id (core.scopes): None outside any scope;
    # inherited from the parent at creation so every descendant of a
    # scope root routes through that scope's policy slot and admission
    # ring without per-submit lookups.
    scope: Optional[int] = None
    # Fault tolerance (core.errors): how many times the runtime may
    # re-dispatch this task after a worker loss / timeout / body error
    # before poisoning it (0 = fail fast, today's semantics). Retries
    # are at-least-once: a body may have partially run before the
    # retry, so retryable bodies must be idempotent.
    retries: int = 0
    # Dispatch-to-done deadline in seconds, enforced by the process
    # backend's supervisor (the stuck worker is killed + respawned and
    # the task retried or poisoned). Advisory under threads: a Python
    # thread cannot be preempted mid-body.
    timeout: Optional[float] = None
    # Remaining retry budget (counts down from `retries`) and the
    # attempt history: one {"worker", "reason", "t"} dict per failed
    # attempt, surfaced in TaskFailed when the budget runs out.
    retries_left: int = 0
    attempts: list = field(default_factory=list)
    # Set when the owning scope expired before this task ran: the body
    # is skipped (drain-and-fail) and the scope's taskwait raises
    # ScopeExpired.
    cancelled: bool = False

    wd_id: int = field(default_factory=lambda: next(_wd_ids))
    state: TaskState = TaskState.CREATED
    # Dependence bookkeeping (owned by the manager / graph lock holder).
    num_predecessors: int = 0
    successors: list = field(default_factory=list)
    # Children bookkeeping for taskwait + lifetime (paper: parent WD holds
    # the graph of its children and may not be deleted while referenced).
    num_children_alive: int = 0
    children_done_event: Optional[threading.Event] = None
    result: Any = None
    # Sharded-mode bookkeeping (core.shards), set by the ShardRouter at
    # submit time; None in every other mode.
    #   shard_pending — submit latch + unsatisfied predecessor edges;
    #                   the unique decrement to 0 marks the task ready.
    #   shard_done    — per-shard Done portions outstanding; the unique
    #                   decrement to 0 completes the WD.
    #   shard_parts   — {shard_index: [(map_key, mode), ...]} dep
    #                   partition, hashed once so shards never re-hash.
    shard_pending: Any = None
    shard_done: Any = None
    shard_parts: Any = None
    # Guards num_children_alive: in dast/ddast/sharded modes sibling
    # completions are processed by concurrent managers, so the +1/-1
    # pair below must be atomic with respect to each other.
    _children_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False)

    def __post_init__(self) -> None:
        self.retries_left = self.retries
        if self.parent is not None:
            if self.scope is None:
                self.scope = self.parent.scope
            with self.parent._children_lock:
                self.parent.num_children_alive += 1

    # ---- life-cycle transitions -------------------------------------
    def mark_ready(self) -> None:
        self.state = TaskState.READY

    def mark_running(self) -> None:
        self.state = TaskState.RUNNING

    def mark_finished(self) -> None:
        self.state = TaskState.FINISHED

    def mark_completed(self) -> None:
        """Done Task Message fully handled (graph updated, successors
        notified). After this the WD may be reclaimed unless children
        still reference it."""
        self.state = TaskState.COMPLETED
        if self.parent is not None:
            self.parent._child_completed()

    def _child_completed(self) -> None:
        with self._children_lock:
            self.num_children_alive -= 1
            alive = self.num_children_alive
        if alive == 0 and self.children_done_event is not None:
            self.children_done_event.set()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"WD({self.wd_id}:{self.label}:{self.state.name})"
