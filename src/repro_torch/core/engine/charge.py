"""Copy of `repro/core/engine/charge.py`.

Cost-charging adapter: how one policy implementation runs under two
drivers.

Every :class:`~repro_torch.core.engine.policy.DependencePolicy` mutates *real*
data structures (``DependenceGraph``, ``ShardedDependenceGraph``, shard
mailboxes, ``StealDeque``s) and, around each protocol step, calls a hook
on its :class:`CostCharger`. The two drivers differ only in which charger
they install:

  * ``TaskRuntime`` (real threads) passes the no-op base class — real
    time simply passes, and the ``InstrumentedLock``s inside the
    structures record real contention;
  * ``RuntimeSimulator`` passes :class:`SimCharger`, which advances a
    virtual clock, serializes critical sections on :class:`VirtualLock`s
    (one per lock key), and records the §6.1 cache-pollution flag for
    the acting core.

This is what makes sim-vs-real divergence structurally impossible: the
dependence protocol runs exactly once, in the policy; the charger only
decides what the protocol *costs*.
"""
from __future__ import annotations

from typing import Dict, Hashable, Sequence, Set, Tuple


class CostCharger:
    """No-op charger used by the threaded driver. Method-per-event so the
    simulator can price each protocol step; all bodies are empty here."""

    __slots__ = ()

    def begin(self, slot: int, now: float) -> None:
        """Driver hook: the acting core/worker and its local clock."""

    def create(self) -> None:
        """WD allocation + argument capture."""

    def push(self) -> None:
        """One queue/mailbox push by the producing worker."""

    def message(self) -> None:
        """Manager pop+dispatch of one mailbox/queue entry."""

    def submit_cs(self, key: Hashable, ndeps: int) -> None:
        """Whole-graph Submit critical section under lock ``key``."""

    def done_cs(self, key: Hashable, ndeps: int) -> None:
        """Whole-graph Done critical section under lock ``key``."""

    def submit_portion_cs(self, key: Hashable, nlocal: int,
                          nparts: int) -> None:
        """One shard's portion of a Submit spanning ``nparts`` shards."""

    def done_portion_cs(self, key: Hashable, nlocal: int,
                        nparts: int) -> None:
        """One shard's portion of a Done spanning ``nparts`` shards."""

    def submit_batch_cs(self, key: Hashable,
                        portions: Sequence[Tuple[int, int]]) -> None:
        """A batched Submit: ``portions`` is one (nlocal, nparts) pair per
        task portion applied under a single lock acquisition."""

    def done_batch_cs(self, key: Hashable,
                      portions: Sequence[Tuple[int, int]]) -> None:
        """A batched Done: ``portions`` as in :meth:`submit_batch_cs`."""

    def replay_submit(self) -> None:
        """One record-and-replay Submit: an O(1) structural-key check +
        join-latch decrement — no lock, no message."""

    def replay_done(self, nsuccs: int) -> None:
        """One record-and-replay Done: ``nsuccs`` successor latch
        decrements — no lock, no message."""

    def prio_push(self) -> None:
        """One push into a ready deque's priority lane (critical-path
        replay placement) — a single banded deque append, no lock."""

    def prio_pop(self) -> None:
        """The pop-side band scan while replay priorities are active —
        no lock."""

    def trace_event(self) -> None:
        """One tracing ring-buffer append (core.trace). Free on real
        threads (the append IS the cost); priced in the simulator so
        the traced-vs-untraced overhead gate measures something real."""

    def ipc_submit(self) -> None:
        """One Submit batch encoded + pushed across a process boundary
        (the process backend's exec rings). Free on the real drivers —
        the ring push IS the cost; priced in the simulator so it can
        model ``backend="processes"`` before buying cores. Calibrate
        with ``bench_contention.py --calibrate``."""

    def ipc_done(self) -> None:
        """One Done batch decoded off a process-boundary ring (the
        process backend's done rings); see :meth:`ipc_submit`."""

    def delegate(self) -> None:
        """One Submit/Done portion published to a shard's MPSC request
        list (delegation/combining): a GIL-atomic deque append + a
        trylock attempt — never a blocking wait. Free on real threads;
        priced as ``SimCosts.delegate_us`` in the simulator."""

    def combine(self) -> None:
        """One combine session: the lock holder stages the published
        requests into per-scope buckets and applies them all in a single
        combined critical section. The per-message CS work is still
        charged through the ``*_cs`` hooks; this prices only the session
        setup (``SimCosts.combine_us``)."""

    def metric_event(self) -> None:
        """One live-metrics instrument write (core.metrics): a per-slot
        counter bump / histogram bucket increment. Free on real threads
        — the write IS the cost; priced in the simulator so the
        metrics-overhead gate measures something real."""

    def metric_sample(self) -> None:
        """One sampler pass (core.metrics.MetricsSampler): the idle
        thread that took the tick walks every registered probe and
        appends to the series rings. Amortized — at most one per
        sampling interval, never on the task hot path."""


class VirtualLock:
    """Serializes critical sections in virtual time (FIFO-handover
    approximation: an acquirer at local time t waits until ``free_at``)."""

    __slots__ = ("free_at", "wait_us", "acquisitions")

    def __init__(self) -> None:
        self.free_at = 0.0
        self.wait_us = 0.0
        self.acquisitions = 0

    def acquire(self, t: float, hold: float, overhead: float) -> float:
        start = max(t, self.free_at)
        self.wait_us += start - t
        self.acquisitions += 1
        end = start + hold + overhead
        self.free_at = end
        return end

    def delegated(self, t: float, hold: float, overhead: float) -> None:
        """Wait-free occupancy (delegation/combining): the shard still
        serializes the critical-section work — ``free_at`` advances past
        any in-progress holder — but the acting core never queues on it,
        so no wait accrues. This is the simulator's model of the trylock
        + publication-list protocol."""
        start = max(t, self.free_at)
        self.acquisitions += 1
        self.free_at = start + hold + overhead


class SimCharger(CostCharger):
    """Virtual-time charger: prices every protocol step with
    :class:`~repro_torch.core.simulator.SimCosts` and keeps one
    :class:`VirtualLock` per lock key (``"graph"`` for the global-lock
    policies, ``("shard", i)`` per shard for the sharded one)."""

    __slots__ = ("costs", "now", "slot", "vlocks", "polluted",
                 "delegation")

    def __init__(self, costs, delegation: bool = False) -> None:
        self.costs = costs
        self.now = 0.0
        self.slot = -1
        self.vlocks: Dict[Hashable, VirtualLock] = {}
        # cores whose next task body runs ``costs.pollution`` slower
        # because they touched runtime structures (paper §6.1)
        self.polluted: Set[int] = set()
        # delegation/combining on: shard critical sections are applied
        # through the publication-list protocol, so they occupy the
        # shard's VirtualLock without making the acting core wait.
        self.delegation = delegation

    # -- driver side ----------------------------------------------------
    def begin(self, slot: int, now: float) -> None:
        self.slot = slot
        self.now = now

    # -- priced protocol steps ------------------------------------------
    def create(self) -> None:
        self.now += self.costs.create

    def push(self) -> None:
        self.now += self.costs.push

    def message(self) -> None:
        self.now += self.costs.msg_overhead

    def _acquire(self, key: Hashable, hold: float) -> None:
        vl = self.vlocks.get(key)
        if vl is None:
            vl = self.vlocks[key] = VirtualLock()
        if self.delegation and type(key) is tuple and key[0] == "shard":
            # wait-free: the combiner pays the CS work on its own clock
            # (someone must do it) but never queues behind the shard —
            # the published portion would simply be applied later.
            vl.delegated(self.now, hold, self.costs.lock_overhead)
            self.now += hold + self.costs.lock_overhead
        else:
            self.now = vl.acquire(self.now, hold,
                                  self.costs.lock_overhead)
        self.polluted.add(self.slot)

    def submit_cs(self, key: Hashable, ndeps: int) -> None:
        c = self.costs
        self._acquire(key, c.submit_cs + c.submit_cs_dep * ndeps)

    def done_cs(self, key: Hashable, ndeps: int) -> None:
        c = self.costs
        self._acquire(key, c.done_cs + c.done_cs_dep * ndeps)

    def _portion_hold(self, base: float, per_dep: float, nlocal: int,
                      nparts: int) -> float:
        # base cost split across the k shard portions, plus the measured
        # fixed per-portion overhead (latch arithmetic, mailbox dispatch)
        # and the per-dependence cost charged where the dep lives.
        return (base / max(nparts, 1) + self.costs.portion_overhead
                + per_dep * nlocal)

    def submit_portion_cs(self, key: Hashable, nlocal: int,
                          nparts: int) -> None:
        c = self.costs
        self._acquire(key, self._portion_hold(c.submit_cs, c.submit_cs_dep,
                                              nlocal, nparts))

    def done_portion_cs(self, key: Hashable, nlocal: int,
                        nparts: int) -> None:
        c = self.costs
        self._acquire(key, self._portion_hold(c.done_cs, c.done_cs_dep,
                                              nlocal, nparts))

    def submit_batch_cs(self, key: Hashable,
                        portions: Sequence[Tuple[int, int]]) -> None:
        c = self.costs
        hold = sum(self._portion_hold(c.submit_cs, c.submit_cs_dep, nl, np)
                   for nl, np in portions)
        self._acquire(key, hold)

    def done_batch_cs(self, key: Hashable,
                      portions: Sequence[Tuple[int, int]]) -> None:
        c = self.costs
        hold = sum(self._portion_hold(c.done_cs, c.done_cs_dep, nl, np)
                   for nl, np in portions)
        self._acquire(key, hold)

    # Replay steps touch no shared structure: pure local-time cost, no
    # VirtualLock and — deliberately — no pollution flag, which is how
    # the simulator models the §6.1 cache win compounding with replay.
    def replay_submit(self) -> None:
        self.now += self.costs.replay_submit

    def replay_done(self, nsuccs: int) -> None:
        self.now += (self.costs.replay_done
                     + self.costs.replay_dec * nsuccs)

    # Priority-lane traffic (critical-path placement): banded deque
    # appends and the pop-side band scan — local-time only, no
    # VirtualLock, no pollution flag (the lane is lock-free by design).
    def prio_push(self) -> None:
        self.now += self.costs.prio_push

    def prio_pop(self) -> None:
        self.now += self.costs.prio_pop

    # Tracing stamps are lock-free appends: local-time cost only, no
    # VirtualLock, no pollution flag.
    def trace_event(self) -> None:
        self.now += self.costs.trace_event

    # Live-metrics writes follow the tracing model exactly: per-slot
    # GIL-atomic stores, so local-time cost only — no VirtualLock, no
    # pollution flag. Sampling is the rate-limited read-side pass.
    def metric_event(self) -> None:
        self.now += self.costs.metric_event

    def metric_sample(self) -> None:
        self.now += self.costs.metric_sample

    # Cross-process ring traffic (modeling backend="processes"): the
    # rings are SPSC, so there is no lock to serialize on — pure
    # serialization + copy time on the acting side.
    def ipc_submit(self) -> None:
        self.now += self.costs.ipc_submit_us

    def ipc_done(self) -> None:
        self.now += self.costs.ipc_done_us

    # Delegation/combining: the publication append is lock-free
    # (local-time cost only); the combine-session setup is paid by the
    # lock holder, whose CS occupancy flows through _acquire above.
    def delegate(self) -> None:
        self.now += self.costs.delegate_us

    def combine(self) -> None:
        self.now += self.costs.combine_us

    # -- result aggregation ---------------------------------------------
    def lock_wait_us(self) -> float:
        return sum(v.wait_us for v in self.vlocks.values())

    def lock_acquisitions(self) -> int:
        return sum(v.acquisitions for v in self.vlocks.values())

    def max_free_at(self) -> float:
        return max((v.free_at for v in self.vlocks.values()), default=0.0)
