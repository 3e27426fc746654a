"""Copy of `repro/core/scopes/policy.py`.

ScopedPolicy: per-scope dependence/replay multiplexer over ONE live
policy.

Every scope needs its own record-and-replay slot — scope A freezing its
recording at its own taskwait must not validate, reset, or retire scope
B's — but the live dependence machinery (graphs, shards, mailboxes,
managers) is exactly the shared resource multi-tenancy is about. So the
multiplexer keeps ONE wrapped :class:`DependencePolicy` and gives each
scope (plus the driver's default root context) its own
:class:`~repro_torch.core.engine.replay.ReplayPolicy` wrapper *around that
same inner policy*. Routing is the ``WorkDescriptor.scope`` stamp,
inherited from the parent at creation: submit/complete go to the
owning scope's slot; ``notify_quiescent(root, scope_id=...)`` goes to
exactly one slot, so iteration boundaries are per-tenant.

Scope wrappers publish their bottom levels with a ``scope`` tag:
several frozen graphs share one placement, and their structural ids
index *per-scope* band tables that
:class:`~repro_torch.core.sched.placement.CriticalPathPlacement` merges into
one shared set of band-occupancy counters (a fixed band universe), so
multi-tenant replay regains global longest-chain-first. Replayed ready
tasks still flow through the normal admission path (see
:class:`~repro_torch.core.scopes.admission.FairAdmission`), which preserves
the band through its ring via the ``_replay_sid`` stash.

Manager-side behavior (idle callbacks, drain loops, flush, batching) is
scope-blind by design — a drained Submit message carries its WD, and
the graphs it lands in are already per-parent — so those calls forward
straight to the inner policy.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..engine.policy import DependencePolicy
from ..engine.replay import ReplayPolicy
from ..shards.steal_deque import AtomicCounter
from ..wd import WorkDescriptor


def scope_rollup(placement, policy, scope_id: int,
                 scope=None) -> Dict[str, object]:
    """One scope's per-tenant stats entry, shared by both drivers (the
    threaded RuntimeStats.scopes and the simulator SimResult.scopes):
    admission counters from the FairAdmission ring plus the scope's
    replay-slot counters — and, when the :class:`JobScope` itself is
    passed and carries a deadline, its SLO attainment snapshot."""
    entry: Dict[str, object] = dict(placement.scope_admission(scope_id))
    steals = getattr(placement, "scope_steals", {}).get(scope_id)
    entry["steals"] = steals.value if steals is not None else 0
    pol = policy.scope_policy(scope_id)
    entry["replay_iterations"] = getattr(pol, "replay_iterations", 0)
    entry["replayed_tasks"] = getattr(pol, "replayed_tasks", 0)
    # per-tenant drain share: dependence-analysis portions consumed on
    # this scope's behalf by the scope-fair drain rotation (ddast queue
    # quanta / sharded combiner buckets); 0 for policies without one
    share = getattr(policy, "scope_drain_share", None)
    entry["drained_portions"] = share(scope_id) if callable(share) else 0
    if scope is not None:
        slo = scope.slo_snapshot()
        if slo is not None:
            entry["slo"] = slo
    return entry


class ScopedPolicy(DependencePolicy):
    """Multiplex scope-tagged protocol calls over one inner policy."""

    def __init__(self, inner: DependencePolicy,
                 replay: bool = False) -> None:
        # deliberately NOT calling super().__init__: the wrapped policy
        # owns slots/params/placement/charge; we route and delegate.
        self.inner = inner
        self.replay = replay
        self.name = f"scoped({inner.name})"
        self._default: DependencePolicy = (
            ReplayPolicy(inner, publish_priorities=False) if replay
            else inner)
        self._slots: Dict[int, DependencePolicy] = {}
        # per-scope task tallies: nested children of one scope are
        # submitted by concurrent worker threads, so a plain int +=
        # would drop counts (dict.setdefault is GIL-atomic)
        self.scope_tasks: Dict[Optional[int], AtomicCounter] = {}

    # ------------------------------------------------------------------
    # delegation plumbing (same shape as ReplayPolicy's)
    def __getattr__(self, item: str):
        return getattr(object.__getattribute__(self, "inner"), item)

    @property
    def needs_manager_thread(self) -> bool:
        return self.inner.needs_manager_thread

    @property
    def uses_idle_managers(self) -> bool:
        return self.inner.uses_idle_managers

    @property
    def idle_sleep_s(self) -> float:
        return self.inner.idle_sleep_s

    @property
    def callback_entries(self) -> int:
        return self.inner.callback_entries

    @property
    def messages_processed(self) -> int:
        return self.inner.messages_processed

    # ------------------------------------------------------------------
    # scope registry
    def register_scope(self, scope_id: int) -> DependencePolicy:
        """Allocate the scope's policy slot: an independent replay
        wrapper when replay is on, the shared inner policy otherwise."""
        if scope_id in self._slots:
            raise ValueError(f"scope {scope_id} already registered")
        pol = (ReplayPolicy(self.inner, scope=scope_id)
               if self.replay else self.inner)
        self._slots[scope_id] = pol
        return pol

    def scope_policy(self, scope_id: Optional[int]) -> DependencePolicy:
        if scope_id is None:
            return self._default
        return self._slots.get(scope_id, self._default)

    def _wrappers(self) -> List[ReplayPolicy]:
        out = []
        if isinstance(self._default, ReplayPolicy):
            out.append(self._default)
        for p in self._slots.values():
            if isinstance(p, ReplayPolicy):
                out.append(p)
        return out

    # ------------------------------------------------------------------
    # routed protocol
    def submit(self, wd: WorkDescriptor, slot: int) -> None:
        sid = wd.scope
        self.scope_tasks.setdefault(sid, AtomicCounter(0)).add(1)
        self.scope_policy(sid).submit(wd, slot)

    def complete(self, wd: WorkDescriptor, slot: int) -> None:
        self.scope_policy(wd.scope).complete(wd, slot)

    def notify_quiescent(self, root: bool = True,
                         scope_id: Optional[int] = None) -> None:
        self.scope_policy(scope_id).notify_quiescent(root)

    # ------------------------------------------------------------------
    # scope-blind protocol: straight to the inner policy
    def idle_callback(self, worker_id: int) -> int:
        return self.inner.idle_callback(worker_id)

    def drain_all(self) -> int:
        return self.inner.drain_all()

    def flush(self, slot: int) -> None:
        self.inner.flush(slot)

    # ------------------------------------------------------------------
    # probes fold in every slot's replay-side state (computed against
    # the inner policy directly — the wrappers share it, so calling
    # their pending()/in_graph() would double-count it)
    def pending(self) -> int:
        n = self.inner.pending()
        for w in self._wrappers():
            n += w._div_buffered
        return n

    def in_graph(self) -> int:
        n = self.inner.in_graph()
        for w in self._wrappers():
            n += w._live.value
        return n

    @property
    def recording_live(self) -> bool:
        """True while ANY tenant is mid-recording — global
        reconfiguration (shard resize) must wait for all of them."""
        return any(w.recording_live for w in self._wrappers())

    def stats(self) -> Dict[str, object]:
        st = dict(self.inner.stats())
        if self.replay:
            agg = {"state": "scoped", "recordings": 0,
                   "replay_iterations": 0, "replayed_tasks": 0,
                   "invalidations": 0, "cache_hits": 0,
                   "cached_recordings": 0, "recorded_tasks": 0,
                   "recorded_edges": 0}
            for w in self._wrappers():
                rep = w.stats()["replay"]
                for k in ("recordings", "replay_iterations",
                          "replayed_tasks", "invalidations", "cache_hits",
                          "cached_recordings", "recorded_tasks",
                          "recorded_edges"):
                    agg[k] += rep[k]
            st["replay"] = agg
        st["scope_tasks"] = {k: c.value
                             for k, c in self.scope_tasks.items()}
        return st
