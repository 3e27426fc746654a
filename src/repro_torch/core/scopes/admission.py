"""Copy of `repro/core/scopes/admission.py`.

FairAdmission: weighted deficit round-robin between scopes and the
shared ready pool.

Without it, ready-task production flows straight into the
:class:`~repro_torch.core.sched.placement.PlacementPolicy`'s per-slot deques,
so a tenant that floods (a huge graph, a tight submit loop) owns the
workers and every other tenant starves behind it. FairAdmission sits
between the two: a ready task belonging to scope *s* first lands in
scope *s*'s **ready ring** (a plain ``collections.deque`` — append and
popleft are GIL-atomic, so producers on any thread and admitters on any
thread never corrupt it, and no lock is introduced); an **admission
pass** (run by every push and every pop — whichever thread is already
here) moves ring entries into the underlying placement by weighted
deficit round-robin: each visit grants a scope ``weight`` units of
deficit, each admitted task spends one, so over any contended window
scopes are served in weight proportion regardless of who floods.

Admission is bounded twice. A shared **window** (default two tasks per
slot) caps the total admitted-but-not-yet-popped population: the
placement deques only need about one ready task per worker to keep
everyone busy, and making the window the scarce resource is what turns
the deficit scheduler into *weighted* sharing — every freed slot is a
service opportunity granted to the largest-deficit backlogged scope,
so grants converge to the weight ratio (plain eager admission would
degenerate to FIFO-by-arrival). ``max_inflight`` is the per-scope
version of the same bound: a tenant-specific ceiling inside the
window. Both release at pop (execution start), so neither can deadlock
a blocked parent — a capped scope's surplus simply waits in its own
ring, invisible to other tenants' latency.

Bookkeeping races are deliberate and benign: deficit counters and the
admitted/wait counters are plain ints (a lost update skews fairness by
one task); the inflight gauge reuses the runtime's
:class:`~repro_torch.core.shards.AtomicCounter` (per-scope, two touches per
task — the same reasoning as the per-WD join counters) because an
inflight leak, unlike a deficit skew, would throttle a scope forever.

Tasks with no scope stamp (``wd.scope is None`` — the driver's own root
context) bypass the rings entirely: the default context is not a
tenant.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from ..shards.steal_deque import AtomicCounter
from ..sched.placement import PlacementPolicy
from ..trace import EV_ADMIT_DEFER
from ..wd import WorkDescriptor


class _ScopeRing:
    __slots__ = ("scope_id", "weight", "max_inflight", "ring", "deficit",
                 "inflight", "admitted", "pushed", "admission_waits",
                 "max_queued", "expired_fn", "drained", "contended_grants")

    def __init__(self, scope_id: int, weight: float,
                 max_inflight: Optional[int],
                 expired_fn=None) -> None:
        self.scope_id = scope_id
        self.weight = weight
        self.max_inflight = max_inflight
        self.ring: deque = deque()
        self.deficit = 0.0
        self.inflight = AtomicCounter(0)
        self.admitted = 0
        self.pushed = 0
        #: tasks (not spin passes) that were NOT admitted at push time —
        #: each waited in the ring for at least one later admission pass
        self.admission_waits = 0
        self.max_queued = 0
        #: expiry probe (JobScope.is_expired): once it answers True the
        #: scope's queued tasks drain-and-fail instead of admitting
        self.expired_fn = expired_fn
        self.drained = 0
        #: grants taken while EVERY registered ring was backlogged —
        #: the only window where weighted fairness is defined (an
        #: uncontended grant is just work conservation). The per-scope
        #: ratio of these converges to the weight ratio; the fairness
        #: benches gate on it because exec-order ratios dilute whenever
        #: a tenant's readiness production, not admission, is the
        #: bottleneck.
        self.contended_grants = 0


class FairAdmission(PlacementPolicy):
    """Wraps any :class:`PlacementPolicy`; same surface, fair front."""

    #: shared admission window, in multiples of the slot count
    DEFAULT_WINDOW_SLOTS = 2

    def __init__(self, inner: PlacementPolicy,
                 window: Optional[int] = None) -> None:
        # deliberately NOT calling super().__init__: the wrapped
        # placement owns the deques; we own only the scope rings.
        self.inner = inner
        self._rings: Dict[int, _ScopeRing] = {}
        self._ring_list: List[_ScopeRing] = []   # stable visit order
        self._window = window if window is not None else \
            self.DEFAULT_WINDOW_SLOTS * max(len(inner.deques), 1)
        self._inflight = AtomicCounter(0)        # window occupancy

    # -- scope registry -------------------------------------------------
    def register_scope(self, scope_id: int, weight: float = 1.0,
                       max_inflight: Optional[int] = None,
                       expired_fn=None) -> None:
        if scope_id in self._rings:
            raise ValueError(f"scope {scope_id} already registered")
        r = _ScopeRing(scope_id, weight, max_inflight, expired_fn)
        self._rings[scope_id] = r
        self._ring_list.append(r)

    # -- forwarded surface ----------------------------------------------
    @property
    def deques(self):
        return self.inner.deques

    @property
    def charge(self):
        return self.inner.charge

    @charge.setter
    def charge(self, c) -> None:
        # the policy ctor wires its CostCharger through `placement.charge`
        self.inner.charge = c

    @property
    def tracer(self):
        return self.inner.tracer

    @tracer.setter
    def tracer(self, t) -> None:
        # same wiring path as `charge`: the inner placement stamps the
        # ready/steal events, this wrapper stamps admission deferrals
        self.inner.tracer = t

    @property
    def scope_steals(self):
        return self.inner.scope_steals

    @property
    def wants_replay_priorities(self) -> bool:
        return self.inner.wants_replay_priorities

    def set_replay_priorities(self, levels, scope=None) -> None:
        self.inner.set_replay_priorities(levels, scope=scope)

    def clear_replay_priorities(self, scope=None) -> None:
        self.inner.clear_replay_priorities(scope=scope)

    def note_executed(self, wd: WorkDescriptor, slot: int) -> None:
        self.inner.note_executed(wd, slot)

    def set_num_shards(self, num_shards: int) -> None:
        """Forwarded so an online shard-count retune
        (``ShardedPolicy.resize``) still re-keys a shard-affine inner
        placement through this wrapper."""
        rekey = getattr(self.inner, "set_num_shards", None)
        if rekey is not None:
            rekey(num_shards)

    def stats(self) -> Dict[str, int]:
        st = self.inner.stats()
        st["admission_waits"] = sum(r.admission_waits
                                    for r in self._ring_list)
        return st

    # -- admission ------------------------------------------------------
    def scope_admission(self, scope_id: int) -> Dict[str, int]:
        r = self._rings[scope_id]
        return {"admitted": r.admitted,
                "admission_waits": r.admission_waits,
                "max_queued": r.max_queued,
                "drained": r.drained,
                "contended_grants": r.contended_grants,
                "weight": r.weight}

    def _drain_one(self, r: _ScopeRing, wd: WorkDescriptor) -> None:
        """Route one task of an expired scope straight to the inner
        placement as a cancelled no-op: workers pop it and skip the
        body, so the scope's graph drains without executing — and
        without occupying a window slot (``_fair_admitted`` stays
        unset, so the pop-side release skips it too)."""
        wd.cancelled = True
        r.drained += 1
        self.inner.push(wd)

    def _drain_expired(self) -> None:
        for r in self._ring_list:
            if r.ring and r.expired_fn is not None and r.expired_fn():
                while True:
                    try:
                        wd = r.ring.popleft()
                    except IndexError:
                        break
                    self._drain_one(r, wd)

    def _admit(self) -> None:
        """Weighted-deficit drain of the scope rings into the inner
        placement, one window slot at a time: every grant lets each
        backlogged cap-eligible scope accrue ``weight`` deficit, the
        largest-deficit scope takes the slot and pays the round's total
        weight — so over any contended window grants converge to the
        weight ratio, even though slots free one pop at a time. Runs on
        whichever thread is already pushing or popping; concurrent
        passes interleave harmlessly (each ring entry is popped exactly
        once — deque atomicity — and deficit skew from racing += is
        bounded by one round)."""
        self._drain_expired()
        rings = self._ring_list
        while True:
            if self._inflight.value >= self._window:
                return                      # backlog waits for a pop
            best = None
            total_w = 0.0
            backlogged = 0
            for r in rings:
                if not r.ring:
                    r.deficit = 0.0
                    continue
                backlogged += 1
                cap = r.max_inflight
                if cap is not None and r.inflight.value >= cap:
                    continue                # capped: no opportunity
                r.deficit += r.weight
                total_w += r.weight
                if best is None or r.deficit > best.deficit:
                    best = r
            if best is None:
                return
            try:
                wd = best.ring.popleft()
            except IndexError:              # raced another admitter
                continue
            best.deficit -= total_w
            best.inflight.add(1)
            self._inflight.add(1)
            best.admitted += 1
            if backlogged == len(rings) and backlogged > 1:
                best.contended_grants += 1
            wd._fair_admitted = True    # pop releases only real grants
            sid = getattr(wd, "_replay_sid", None)
            if sid is not None:
                wd._replay_sid = None   # band preserved through the ring
                self.inner.push_replay(wd, sid)
            else:
                self.inner.push(wd)

    def push(self, wd: WorkDescriptor) -> None:
        r = self._rings.get(wd.scope) if wd.scope is not None else None
        if r is None:
            self.inner.push(wd)
            return
        if r.expired_fn is not None and r.expired_fn():
            self._drain_one(r, wd)      # expired: drain-and-fail, no
            return                      # ring residency, no admission
        r.ring.append(wd)
        r.pushed += 1
        seq = r.pushed
        if len(r.ring) > r.max_queued:
            r.max_queued = len(r.ring)
        self._admit()
        # this task deferred (window/cap/deficit) iff the admission
        # pass above did not reach it — one count per waiting TASK, so
        # the metric is comparable between spinning threads and the sim
        if r.admitted < seq:
            r.admission_waits += 1
            tr = self.inner.tracer
            if tr.enabled:
                tr.task_event(EV_ADMIT_DEFER, wd, -1,
                              data={"queued": len(r.ring)})

    def push_replay(self, wd: WorkDescriptor, sid: int) -> None:
        # A replayed ready task of a tenant still queues through the
        # fair ring, but its band must survive admission: the sid is
        # stashed on the WD so _admit (possibly on another thread, much
        # later) can re-enter the inner placement's priority path and
        # land the task in its tenant's band table.
        if wd.scope is not None and wd.scope in self._rings:
            wd._replay_sid = sid
            self.push(wd)
        else:
            self.inner.push_replay(wd, sid)

    def pop(self, slot: int) -> Optional[WorkDescriptor]:
        if self._ring_list:
            self._admit()
        wd = self.inner.pop(slot)
        if wd is not None and wd.scope is not None \
                and getattr(wd, "_fair_admitted", False):
            wd._fair_admitted = False
            r = self._rings.get(wd.scope)
            if r is not None:           # backpressure releases at pop
                r.inflight.add(-1)
                self._inflight.add(-1)
        return wd

    def ready_count(self) -> int:
        n = self.inner.ready_count()
        for r in self._ring_list:
            n += len(r.ring)
        return n

    # -- live-metrics probes (read-only, lock-free, approximate under
    # -- concurrency by the same argument as the bookkeeping counters) --
    def admission_backlog(self) -> int:
        """Tasks waiting in scope rings, not yet granted a window slot."""
        return sum(len(r.ring) for r in self._ring_list)

    def admission_waits_total(self) -> int:
        return sum(r.admission_waits for r in self._ring_list)

    def scope_inflight(self) -> Dict[int, int]:
        """Per-scope window occupancy (admitted, not yet popped)."""
        return {r.scope_id: r.inflight.value for r in self._ring_list}
