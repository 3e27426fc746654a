"""Copy of `repro/core/scopes/scope.py`.

JobScope: a first-class root context, plus the region-keying shim.

A scope is to the runtime what a tenant is to a service: its tasks form
an independent graph under the scope's own root WD, its ``taskwait()``
quiesces only that graph, and its regions live in a namespace no other
scope can alias. The namespace comes from ONE shim —
:func:`scoped_deps` wraps every declared region as
``ScopedRegion(scope, region)`` at the moment a task enters the policy
boundary — so every downstream consumer of region keys (the RAW/WAW/WAR
rules, the shard hash, the placement affinity map, the replay
structural keys) separates tenants for free, in all four policies.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

from ..metrics import LogHistogram
from ..wd import TaskState, WorkDescriptor


class ScopedRegion(NamedTuple):
    """A region key qualified by the scope that declared it. Compares
    and hashes by value like any region tuple, and its ``repr`` is
    stable, so :func:`~repro_torch.core.shards.stable_region_hash` spreads the
    same app region to *different* shards for different scopes."""
    scope: int
    region: Any


def scoped_deps(scope_id: Optional[int], deps: Sequence[Tuple[Any, Any]]
                ) -> Sequence[Tuple[Any, Any]]:
    """The keying shim: fold ``scope_id`` into every region key of a
    dependence list. Identity for the default (scope-less) context, so
    non-tenant code pays nothing."""
    if scope_id is None:
        return deps
    return tuple((ScopedRegion(scope_id, region), mode)
                 for region, mode in deps)


class JobScope:
    """One tenant's root context inside a shared ``TaskRuntime``.

    Created by ``TaskRuntime.open_scope(name, weight=, max_inflight=)``;
    usable as a context manager (``with rt.open_scope("a") as sc:``) —
    entering makes the scope root the calling thread's current task so
    plain ``rt.task(...)`` submissions land in the scope; exiting
    taskwaits and closes. ``task()``/``taskwait()`` also work
    explicitly, from the opening thread (each submitting thread owns
    one SPSC submit queue — the §3.1 single-producer discipline — so a
    scope's top-level tasks must come from one thread; *nested* tasks
    created by worker threads executing scope tasks inherit the scope
    through their parent and use the worker's own slot).

    ``weight`` and ``max_inflight`` parameterize the
    :class:`~repro_torch.core.scopes.admission.FairAdmission` layer: weight
    is the scope's deficit-round-robin share of ready-task admission;
    ``max_inflight`` bounds how many of the scope's ready tasks may
    occupy the shared ready deques at once (backpressure — a flooding
    tenant queues in its own ring, not in the shared pool).
    """

    def __init__(self, runtime, scope_id: int, name: str,
                 weight: float = 1.0,
                 max_inflight: Optional[int] = None,
                 deadline: Optional[float] = None,
                 budget: Optional[float] = None) -> None:
        if weight <= 0:
            raise ValueError("weight must be > 0")
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if deadline is not None and deadline <= 0:
            raise ValueError("deadline must be > 0 seconds")
        if budget is not None and budget <= 0:
            raise ValueError("budget must be > 0 seconds")
        self._rt = runtime
        self.scope_id = scope_id
        self.name = name
        self.weight = weight
        self.max_inflight = max_inflight
        # expiry bounds: wall-clock seconds from open, and summed
        # body-execution seconds (charged by the runtime per finished
        # task). Once either runs out, FairAdmission drains this
        # scope's queued tasks unrun and taskwait raises ScopeExpired.
        self.deadline = deadline
        self.budget = budget
        self._budget_used = 0.0
        self._expired_reason: Optional[str] = None
        self._expiry_traced = False     # counted/traced once (runtime)
        self._expiry_raised = False     # ScopeExpired raised once
        self.root = WorkDescriptor(func=None, label=f"scope:{name}",
                                   scope=scope_id)
        self.root.state = TaskState.RUNNING
        self.root.is_scope_root = True
        self.iterations = 0             # root taskwaits reached
        self.opened_s = time.perf_counter()
        self.closed_s: Optional[float] = None
        # the owning client thread's submit slot, when one was
        # allocated for it (recycled at close — see runtime)
        self._client_slot: Optional[int] = None
        # -- SLO accounting (deadline scopes only) ----------------------
        # Per-slot met/missed counters + slack histograms, written by
        # whichever worker finishes the task (single writer per slot —
        # GIL-atomic, exact, zero locks), merged at slo_snapshot() read
        # time. Built eagerly at open so there is no first-write race;
        # slots allocated later (on-demand client slots) clamp to the
        # trailing overflow slot.
        self._slo_met: Optional[list] = None
        self._slo_missed: Optional[list] = None
        self._slo_slack: Optional[list] = None
        if deadline is not None:
            n = (getattr(runtime, "num_workers", 0) + 1
                 + getattr(runtime, "num_clients", 0) + 1)  # +1 overflow
            self._slo_met = [0] * n
            self._slo_missed = [0] * n
            self._slo_slack = [LogHistogram(1e-6) for _ in range(n)]

    # -- SLO attainment -------------------------------------------------
    def note_completion(self, slot: int, elapsed_s: float,
                        cancelled: bool = False) -> None:
        """Record one task outcome against the scope deadline. Called
        by the finishing worker with ``elapsed_s`` = seconds since the
        scope opened; ``cancelled`` marks tasks drained unrun after
        expiry (always a miss, no slack sample — they never executed)."""
        if self.deadline is None:
            return
        n = len(self._slo_met)
        s = slot if 0 <= slot < n - 1 else n - 1
        slack = self.deadline - elapsed_s
        if cancelled or slack < 0:
            self._slo_missed[s] += 1
        else:
            self._slo_met[s] += 1
        if not cancelled:
            self._slo_slack[s].record(max(slack, 0.0))

    def slo_snapshot(self) -> Optional[dict]:
        """Aggregated SLO view, or ``None`` for deadline-less scopes:
        met/missed totals, attainment fraction, and the merged deadline-
        slack histogram (seconds of headroom at completion; late
        finishes land in the zero bucket)."""
        if self.deadline is None:
            return None
        met = sum(self._slo_met)
        missed = sum(self._slo_missed)
        total = met + missed
        return {"deadline_s": self.deadline,
                "met": met, "missed": missed,
                "attainment": (met / total) if total else None,
                "slack": LogHistogram.merge_all(
                    list(self._slo_slack)).snapshot()}

    def is_expired(self) -> bool:
        """True once the scope's wall deadline or execution budget ran
        out (sticky). This is the ``expired_fn`` FairAdmission polls:
        its drain path consults only this scope's state, so one
        tenant's expiry never touches another's admission."""
        if self._expired_reason is not None:
            return True
        if self.deadline is not None and \
                time.perf_counter() - self.opened_s > self.deadline:
            self._expired_reason = (
                f"deadline {self.deadline:.3f}s exceeded")
            return True
        if self.budget is not None and self._budget_used > self.budget:
            self._expired_reason = (
                f"budget {self.budget:.3f}s exhausted "
                f"({self._budget_used:.3f}s used)")
            return True
        return False

    @property
    def drained(self) -> int:
        """Tasks FairAdmission drained unrun after this scope expired."""
        adm = getattr(self._rt.placement, "scope_admission", None)
        if adm is None:
            return 0
        try:
            return adm(self.scope_id).get("drained", 0)
        except KeyError:                # pragma: no cover - defensive
            return 0

    # ------------------------------------------------------------------
    def task(self, func: Optional[Callable[..., Any]], *args,
             deps: Sequence[Tuple[Any, Any]] = (),
             label: str = "task", retries: int = 0,
             timeout: Optional[float] = None) -> WorkDescriptor:
        """Create + submit a task under this scope. The parent is the
        calling thread's current task when that task already belongs to
        this scope (nested creation), else the scope root. ``retries``/
        ``timeout`` behave as in :meth:`TaskRuntime.task`."""
        return self._rt._scope_task(self, func, args, deps, label,
                                    retries=retries, timeout=timeout)

    def taskwait(self) -> None:
        """Block until all of THIS scope's tasks completed; the blocked
        thread keeps working (any scope's ready tasks). Reaching
        quiescence is this scope's root iteration boundary — its replay
        recording freezes/validates here, independent of other
        tenants."""
        self._rt._scope_taskwait(self)
        self.iterations += 1

    def close(self) -> None:
        """Taskwait, stop accounting wall time, and recycle the owning
        thread's client slot once its last scope closes. The slot is
        released even when the final taskwait raises (an expired or
        failed scope must not leak its client slot)."""
        if self.closed_s is None:
            self.closed_s = time.perf_counter()
            try:
                self.taskwait()
            finally:
                self.closed_s = time.perf_counter()
                self._rt._release_client_slot(self)

    @property
    def wall_s(self) -> float:
        return (self.closed_s or time.perf_counter()) - self.opened_s

    # ------------------------------------------------------------------
    def __enter__(self) -> "JobScope":
        self._rt._enter_scope(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._rt._exit_scope(self)
        self.close()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"JobScope({self.scope_id}:{self.name!r} "
                f"w={self.weight} cap={self.max_inflight})")
