"""Copy of `repro/core/engine/replay.py`.

Taskgraph record-and-replay: elide dependence analysis on repeated
graph submissions.

The iterative workloads of the paper's §4.2 (matmul epochs, N-Body
timesteps, repeated sparse-LU factorizations) submit a *structurally
identical* dependence graph every iteration, yet every Submit/Done pays
full dependence analysis, mailbox traffic, and lock acquisitions each
time. Taskgraph (Yu et al., 2212.04771) records the task graph once and
replays it; Álvarez et al. (2105.07902) replace per-task graph locking
with precomputed wait-free structures. :class:`ReplayPolicy` brings that
to every :class:`~repro_torch.core.engine.policy.DependencePolicy`:

  * **record** — iteration 1 runs through the wrapped live policy
    unchanged while the wrapper records, per structural key (parent
    nesting position + the task's (region, mode) dependence sequence),
    the order of submissions within each parent's namespace.
  * **freeze** — at the first *root* taskwait quiescence the recording
    is resolved ONCE with the shared dependence rules
    (:func:`~repro_torch.core.depgraph.collect_preds_and_register` — the same
    helper every live graph uses, so replay semantics cannot diverge)
    into an immutable :class:`ReplayGraph`: flat int-indexed successor
    arrays plus one :class:`_GenLatch` join latch per task, reset by a
    generation counter instead of re-allocation.
  * **replay** — subsequent submissions of a structurally identical
    graph bypass graph mutation, mailboxes, and locks entirely:
    ``submit`` is an O(1) key check + latch decrement, ``complete``
    decrements the recorded successors' latches and pushes newly-ready
    tasks straight into the ``PlacementPolicy``. Zero messages, zero
    graph-lock acquisitions on the steady-state path.
  * **prioritize** — at freeze time the wrapper also publishes
    scheduling knowledge to the
    :class:`~repro_torch.core.sched.placement.PlacementPolicy`: per-task
    bottom levels (:func:`~repro_torch.core.sched.dag.bottom_levels` over the
    frozen successor arrays, weighted by the per-task execution-time
    EMAs recorded through the drivers, default 1.0), so a
    critical-path-aware placement can start the longest remaining chain
    first. The EMAs keep updating during replay and the priorities are
    refreshed at each successful iteration boundary (a root-quiescent
    point). Placements that don't want priorities
    (``wants_replay_priorities`` False) skip the computation entirely.
  * **invalidate** — the moment a submission diverges from the
    recording (changed region, changed dep mode, extra task, unknown
    parent) the wrapper falls back: the already-replayed prefix is
    self-contained (dependence analysis only looks backwards, so a
    matching prefix's predecessor edges all lie within the prefix) and
    is left to finish under replay; diverging tasks are buffered per
    parent namespace and handed to the live policy for fresh analysis
    as soon as that namespace's replayed siblings have all completed
    (at which point an empty region map is exactly the correct state).
    The stale recording is *retired into the recording cache* (below),
    not dropped, and the next full iteration re-records. An iteration
    that submits *fewer* tasks than recorded executes correctly
    (two-phase latches: a never-submitted task's latch can never reach
    zero) and invalidates at its quiescence.
  * **multi-recording cache** — frozen graphs are kept in a small LRU
    cache (default 4) keyed by an order-canonical signature of the
    per-parent structural key sequences. Two paths consult it: (a) a
    fresh recording whose signature matches a cached graph reuses it at
    freeze time (no re-resolution, cost EMAs retained); (b) when the
    FIRST submission of an iteration fails to open the active recording
    — nothing replayed yet, so switching is trivially safe — the
    wrapper redispatches to a cached recording whose root namespace
    starts with that key. A/B alternating iteration patterns therefore
    replay both structures instead of re-recording on every switch;
    only structures that diverge mid-iteration still pay a live
    re-record per switch (their shared prefix makes a cold dispatch
    impossible).

The join latch is two-phase: it starts at ``predecessors + 1`` each
generation; the Submit contributes one decrement (after the WD is
registered) and each predecessor completion one more, so a completion
racing ahead of its successor's submission — legal, since different
parents submit from different threads — can never publish an
unregistered task.

Per-parent matching (rather than one global submission sequence) is what
makes replay sound under real threads: a parent's children are created
by the single thread executing the parent (§3.1), so each namespace's
submission order is deterministic, while the interleaving *across*
namespaces is not — and does not matter, because dependences only exist
between siblings (per-parent graphs everywhere in this runtime).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

from ..depgraph import collect_preds_and_register
from ..sched.dag import bottom_levels
from ..shards.steal_deque import AtomicCounter
from ..wd import TaskState, WorkDescriptor
from .policy import DependencePolicy

_ROOT = -1

#: EMA factor for per-task execution-time tracking during replay.
_COST_EMA = 0.25

#: ReplayPolicy states (``replay_state`` property).
RECORDING = "recording"
REPLAYING = "replaying"


class _GenLatch:
    """Join latch reset by generation counter instead of re-allocation.

    ``dec(gen)`` lazily reinstates ``init`` the first time a new
    generation touches the latch, then decrements — so one allocation at
    freeze time serves every replay iteration, and a latch left dirty by
    a partial iteration (never-submitted task, post-divergence
    decrements) self-heals on its next use."""

    __slots__ = ("init", "_gen", "_value", "_lock")

    def __init__(self, init: int) -> None:
        self.init = init
        self._gen = -1
        self._value = init
        self._lock = threading.Lock()

    def dec(self, gen: int) -> int:
        with self._lock:
            if self._gen != gen:
                self._gen = gen
                self._value = self.init
            self._value -= 1
            return self._value


class _RecNode:
    """Identity-only stand-in for a WD during freeze-time analysis."""

    __slots__ = ("sid",)

    def __init__(self, sid: int) -> None:
        self.sid = sid


_DepsKey = Tuple[Tuple[Any, Any], ...]


def _deps_key(wd: WorkDescriptor) -> _DepsKey:
    """Canonical structural key of a task: its (region, mode) sequence.
    Region objects compare by value (they are dict keys everywhere), so
    a changed region, changed mode, or reordered dependence list all
    produce a different key."""
    return tuple((region, mode) for region, mode in wd.deps)


def _task_cost(wd: WorkDescriptor) -> Optional[float]:
    """The task's measured cost: real body time (threaded driver's
    ``exec_dur``, seconds) or virtual duration (simulator, µs) — only
    relative magnitude matters and the two never mix within a run.
    ``None`` when no measurement exists (the bottom-level fallback is a
    unit cost, i.e. chain length)."""
    c = getattr(wd, "exec_dur", None)
    if c is None:
        c = wd.duration
    return c


def _canonical_signature(
        children: Dict[int, List[Tuple[_DepsKey, int]]]) -> Tuple:
    """Order-canonical signature of a recording: each namespace's key
    sequence, tagged by the canonical index of the task heading it,
    enumerated in BFS order from the root namespace. Canonical indices
    are assigned in that same traversal, so the signature is invariant
    to the cross-namespace submission interleaving (which varies run to
    run under real threads) while distinguishing any structural change —
    exactly the equality the multi-recording cache needs."""
    canon: Dict[int, int] = {}
    items: List[Tuple[int, Tuple[_DepsKey, ...]]] = []
    queue: List[int] = [_ROOT]
    qi = 0
    while qi < len(queue):
        psid = queue[qi]
        qi += 1
        kids = children.get(psid)
        if not kids:
            continue
        for _key, sid in kids:
            canon[sid] = len(canon)
            queue.append(sid)
        items.append((_ROOT if psid == _ROOT else canon[psid],
                      tuple(k for k, _ in kids)))
    return tuple(items)


class ReplayGraph:
    """Immutable resolution of one recorded iteration.

    Flat, int-indexed arrays over structural ids (sids) assigned in
    recording order: ``succs[sid]`` — successor sids, ``preds[sid]`` —
    predecessor count, ``parent_sid[sid]`` — the parent's sid (or -1
    for a root-level task), ``latches[sid]`` — the two-phase join latch
    (initial value ``preds[sid] + 1``), ``children[psid]`` — the ordered
    ``(deps_key, sid)`` expectation list replay matches against."""

    __slots__ = ("n", "children", "parent_sid", "succs", "preds",
                 "latches", "root_ids", "total_edges", "costs",
                 "signature")

    def __init__(self, children: Dict[int, List[Tuple[_DepsKey, int]]],
                 parent_sid: List[int], root_ids: Set[int],
                 costs: Optional[Dict[int, float]] = None) -> None:
        n = len(parent_sid)
        self.n = n
        self.children = children
        self.parent_sid = parent_sid
        self.root_ids = root_ids
        # Per-task cost estimates (EMA-updated during replay) feeding the
        # critical-path placement's bottom levels; 1.0 (chain length)
        # until a measurement exists.
        self.costs: List[float] = [
            float((costs or {}).get(sid, 1.0)) for sid in range(n)]
        self.signature: Optional[Tuple] = None
        self.succs: List[List[int]] = [[] for _ in range(n)]
        self.preds: List[int] = [0] * n
        self.total_edges = 0
        # Resolve each namespace once with the SAME region rules the
        # live graphs use — the unified engine's single source of
        # dependence semantics.
        for kids in children.values():
            regions: Dict[Any, Any] = {}
            for key, sid in kids:
                pset = collect_preds_and_register(regions, _RecNode(sid),
                                                  key)
                self.preds[sid] = len(pset)
                self.total_edges += len(pset)
                for p in pset:
                    self.succs[p.sid].append(sid)
        self.latches = [_GenLatch(self.preds[sid] + 1) for sid in range(n)]

    def child_counts(self) -> List[int]:
        """Recorded children per namespace, indexed by psid + 1."""
        counts = [0] * (self.n + 1)
        for psid, kids in self.children.items():
            counts[psid + 1] = len(kids)
        return counts


class ReplayPolicy(DependencePolicy):
    """Record-and-replay wrapper over any live ``DependencePolicy``.

    Protocol calls delegate to the wrapped policy until a recording is
    frozen; from then on structurally matching submissions run on the
    :class:`ReplayGraph` alone. See the module docstring for the state
    machine. Unknown attributes delegate to the wrapped policy, so
    driver conveniences (``router``, ``worker_queues``, ``resize``, …)
    keep working."""

    def __init__(self, inner: DependencePolicy,
                 publish_priorities: bool = True,
                 scope: Optional[int] = None) -> None:
        # deliberately NOT calling super().__init__: the wrapped policy
        # owns slots/params/placement/charge; we delegate.
        self.inner = inner
        self.name = f"replay({inner.name})"
        # Whether this wrapper may drive the placement's banded priority
        # lane. Multi-tenant scope wrappers (core.scopes) set ``scope``
        # so their bottom levels land in a per-scope band table merged
        # into the placement's shared band-occupancy counters (see
        # CriticalPathPlacement) — several independent replay graphs
        # then rank their critical work on one global axis instead of
        # degrading to the normal lane.
        self.publish_priorities = publish_priorities
        self._scope = scope
        self._state = RECORDING
        # -- recording side (guarded by _rec_lock; slow path) ----------
        self._rec_lock = threading.Lock()
        self._rec_keys: List[_DepsKey] = []
        self._rec_parent: List[int] = []
        self._rec_children: Dict[int, List[Tuple[_DepsKey, int]]] = {}
        self._rec_sid_of: Dict[int, int] = {}
        self._rec_roots: Set[int] = set()
        self._rec_costs: Dict[int, float] = {}
        # -- frozen side (allocated once at freeze) --------------------
        self.replay_graph: Optional[ReplayGraph] = None
        self._gen = 0
        self._iter_wds: List[Optional[WorkDescriptor]] = []
        self._iter_sid_of: Dict[int, int] = {}
        self._iter_counts: List[int] = []       # children seen, by psid+1
        self._rec_counts: List[int] = []        # children recorded, ditto
        self._iter_started = False              # any task matched yet?
        # replay tasks in flight per namespace (psid + 1) and in total
        self._outstanding: List[AtomicCounter] = []
        self._live = AtomicCounter(0)
        # -- multi-recording cache (signature -> frozen graph, LRU) ----
        self.cache_size = 4
        self._cache: "OrderedDict[Tuple, ReplayGraph]" = OrderedDict()
        # -- divergence fallback ---------------------------------------
        self._diverged = False
        self._div_lock = threading.Lock()
        self._div_buffers: Dict[int, List[Tuple[WorkDescriptor, int]]] = {}
        self._div_buffered = 0
        # -- stats -----------------------------------------------------
        self.replay_iterations = 0
        self.replayed_tasks = 0
        self.invalidations = 0
        self.recordings = 0
        self.replay_cache_hits = 0

    # ------------------------------------------------------------------
    # delegation plumbing
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

    @property
    def replay_state(self) -> str:
        return self._state

    @property
    def recording_live(self) -> bool:
        """True while the current iteration is being recorded — global
        reconfiguration (e.g. ``ShardedPolicy.resize``) must wait, or
        the recording would freeze against structures that no longer
        exist."""
        return self._state == RECORDING and bool(self._rec_keys)

    def steady_iteration_complete(self) -> bool:
        """True when the in-progress iteration has submitted exactly the
        recorded structure — the whole frozen graph is accounted for and
        ``notify_quiescent`` is guaranteed to count it as a replay
        iteration. The process backend keys its replay plane on this:
        only then may the captured roots run worker-side off the shared
        arrays instead of through the mailboxes."""
        return (self._state == REPLAYING and not self._diverged
                and self._iter_started
                and self._iter_counts == self._rec_counts)

    # ------------------------------------------------------------------
    # protocol: submit
    def submit(self, wd: WorkDescriptor, slot: int) -> None:
        if self._state == RECORDING:
            self._record_submit(wd, slot)
        else:
            self._replay_submit(wd, slot)

    def _record_submit(self, wd: WorkDescriptor, slot: int) -> None:
        key = _deps_key(wd)
        pid = wd.parent.wd_id if wd.parent is not None else None
        with self._rec_lock:
            sid = len(self._rec_keys)
            if pid is None:
                psid = _ROOT
            else:
                psid = self._rec_sid_of.get(pid, _ROOT)
                if psid == _ROOT:
                    # an unrecorded parent at recording time is the
                    # driver's root task (everything else quiesced at
                    # the iteration boundary)
                    self._rec_roots.add(pid)
            self._rec_keys.append(key)
            self._rec_parent.append(psid)
            self._rec_children.setdefault(psid, []).append((key, sid))
            self._rec_sid_of[wd.wd_id] = sid
        self.inner.submit(wd, slot)

    def _replay_submit(self, wd: WorkDescriptor, slot: int) -> None:
        if self._diverged:
            self._fallback_submit(wd, slot)
            return
        g = self.replay_graph
        psid = self._parent_sid(wd)
        if psid is None:                # unknown live parent: structural
            self._invalidate(wd, slot)  # divergence by definition
            return
        idx = self._iter_counts[psid + 1]
        kids = g.children.get(psid)
        if kids is None or idx >= len(kids) \
                or kids[idx][0] != _deps_key(wd):
            if not self._iter_started and psid == _ROOT \
                    and self._redispatch(wd, slot):
                return                  # switched recording / re-recording
            self._invalidate(wd, slot)
            return
        self._iter_started = True
        sid = kids[idx][1]
        self._iter_counts[psid + 1] = idx + 1
        self._iter_wds[sid] = wd
        self._iter_sid_of[wd.wd_id] = sid
        self._outstanding[psid + 1].add(1)
        wd.state = TaskState.SUBMITTED
        self._live.add(1)
        self.replayed_tasks += 1
        self.charge.replay_submit()
        self._dec(sid)                  # the submit-phase latch unit

    def _redispatch(self, wd: WorkDescriptor, slot: int) -> bool:
        """The iteration's FIRST submission does not open the active
        recording. Nothing has been replayed yet, so two safe moves
        exist: switch to a cached recording this submission does open
        (the A/B alternating pattern), or start recording a brand-new
        structure from scratch. Runs race-free: the first root-level
        submission comes from the only thread with runnable work."""
        key = _deps_key(wd)
        for sig in reversed(self._cache):       # MRU first
            g = self._cache[sig]
            if g is self.replay_graph:
                continue
            kids = g.children.get(_ROOT)
            if kids and kids[0][0] == key:
                if wd.parent is not None:
                    # proven to be the driver root by the active graph's
                    # match of psid == _ROOT above
                    g.root_ids.add(wd.parent.wd_id)
                self.replay_cache_hits += 1
                self._activate_graph(g)
                self._iter_started = True
                self._replay_submit(wd, slot)   # re-match: idx 0 fits
                return True
        # no cached structure starts with this task: re-record. The
        # active graph stays cached (the old structure may come back).
        self.invalidations += 1
        self._retire_active()
        self._record_submit(wd, slot)
        return True

    def _parent_sid(self, wd: WorkDescriptor) -> Optional[int]:
        """The parent's structural id this iteration: its sid if it is a
        replayed task, -1 if it is the driver root, None if it is a live
        (non-replayed) task — which cannot happen before divergence."""
        if wd.parent is None:
            return _ROOT
        pid = wd.parent.wd_id
        sid = self._iter_sid_of.get(pid)
        if sid is not None:
            return sid
        if pid in self.replay_graph.root_ids:
            return _ROOT
        return None

    def _dec(self, sid: int) -> None:
        if self.replay_graph.latches[sid].dec(self._gen) == 0:
            wd = self._iter_wds[sid]
            wd.mark_ready()
            if self.publish_priorities:
                self.placement.push_replay(wd, sid)
            else:
                self.placement.push(wd)

    # ------------------------------------------------------------------
    # protocol: complete
    def complete(self, wd: WorkDescriptor, slot: int) -> None:
        sid = self._iter_sid_of.get(wd.wd_id)
        if sid is None:
            if self._state == RECORDING:
                rsid = self._rec_sid_of.get(wd.wd_id)
                if rsid is not None:
                    c = _task_cost(wd)
                    if c is not None:
                        self._rec_costs[rsid] = c
            self.inner.complete(wd, slot)
            return
        g = self.replay_graph
        c = _task_cost(wd)
        if c is not None:               # cost EMA feeds the priorities
            g.costs[sid] += _COST_EMA * (c - g.costs[sid])
        succs = g.succs[sid]
        self.charge.replay_done(len(succs))
        for t in succs:
            self._dec(t)
        psid = g.parent_sid[sid]
        if self._outstanding[psid + 1].add(-1) == 0 and self._diverged:
            self._flush_bucket(psid)
        self._live.add(-1)
        # parent bookkeeping LAST: once the waiter observes zero live
        # children it may reset iteration state, so all of this task's
        # replay bookkeeping must already be done.
        wd.mark_completed()

    # ------------------------------------------------------------------
    # divergence fallback
    def _invalidate(self, wd: WorkDescriptor, slot: int) -> None:
        self.invalidations += 1
        self._diverged = True
        self._fallback_submit(wd, slot)

    def _fallback_submit(self, wd: WorkDescriptor, slot: int) -> None:
        psid = self._parent_sid(wd)
        if psid is None:
            # live parent: none of its children were replay-managed, so
            # its namespace has no replayed predecessors to wait for —
            # straight to live analysis (still under _div_lock so
            # per-parent submission order is preserved vs. any flush
            # running on a completion thread).
            with self._div_lock:
                self.inner.submit(wd, slot)
            return
        with self._div_lock:
            if self._outstanding[psid + 1].value == 0 and \
                    not self._div_buffers.get(psid):
                # every replayed sibling completed (its region records
                # are gone from every live structure), so fresh analysis
                # is correct — submit in creation order, inline.
                self.inner.submit(wd, slot)
                return
            self._div_buffers.setdefault(psid, []).append((wd, slot))
            self._div_buffered += 1

    def _flush_bucket(self, psid: int) -> None:
        with self._div_lock:
            buf = self._div_buffers.pop(psid, None)
            if not buf:
                return
            self._div_buffered -= len(buf)
            for wd, slot in buf:
                self.inner.submit(wd, slot)

    # ------------------------------------------------------------------
    # iteration boundaries
    def notify_quiescent(self, root: bool = True,
                         scope_id: Optional[int] = None) -> None:
        del scope_id                    # routing happens one layer up
        if not root:
            return
        if self._state == RECORDING:
            if self._rec_keys:
                self._freeze()
            return
        # replaying: decide whether the finished iteration kept faith
        if not self._diverged and not self._iter_started:
            return                      # empty boundary (e.g. shutdown)
        if not self._diverged and self._iter_counts == self._rec_counts:
            self.replay_iterations += 1
            self._reset_iteration()
            self._publish_priorities()  # refresh bands from the EMAs
            return
        # structural divergence (mid-iteration fallback, or fewer tasks
        # than recorded): retire the recording into the cache and
        # re-record next iteration (freeze will reuse a cached graph if
        # the new structure has been seen before).
        self.invalidations += 0 if self._diverged else 1
        self._retire_active()

    def _freeze(self) -> None:
        sig = _canonical_signature(self._rec_children)
        g = self._cache.get(sig)
        if g is not None:
            # structurally identical to a cached recording: reuse its
            # resolved graph (and its warmer cost EMAs) outright
            self.replay_cache_hits += 1
            g.root_ids |= self._rec_roots
        else:
            g = ReplayGraph(self._rec_children, self._rec_parent,
                            self._rec_roots, self._rec_costs)
            g.signature = sig
            self.recordings += 1
            self._cache[sig] = g
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        self._activate_graph(g)
        self._reset_recording()

    def _activate_graph(self, g: ReplayGraph) -> None:
        """Make ``g`` the active frozen recording (from a fresh freeze, a
        freeze-time cache hit, or a first-submission redispatch — all
        root-quiescent points). The shared generation counter keeps
        monotonically increasing across activations so a graph's latches
        always see a fresh generation when it comes back."""
        self.replay_graph = g
        self._rec_counts = g.child_counts()
        self._iter_counts = [0] * (g.n + 1)
        self._iter_wds = [None] * g.n
        self._outstanding = [AtomicCounter(0) for _ in range(g.n + 1)]
        self._iter_sid_of = {}
        self._gen += 1
        self._iter_started = False
        self._state = REPLAYING
        if g.signature in self._cache:
            self._cache.move_to_end(g.signature)
        self._publish_priorities()

    def _publish_priorities(self) -> None:
        """Hand the active graph's bottom levels (over the recorded
        successor arrays, weighted by the cost EMAs) to the placement —
        skipped entirely unless the placement asks for them."""
        if not self.publish_priorities:
            return
        if not getattr(self.placement, "wants_replay_priorities", False):
            return
        g = self.replay_graph
        if g is None:
            return
        self.placement.set_replay_priorities(
            bottom_levels(g.succs, g.costs), scope=self._scope)

    def _reset_iteration(self) -> None:
        self._gen += 1
        self._iter_sid_of.clear()
        self._iter_started = False
        counts = self._iter_counts
        for i in range(len(counts)):
            counts[i] = 0
        # _iter_wds entries are overwritten before any latch can reach
        # zero next generation (two-phase latch), so no clear needed.

    def _reset_recording(self) -> None:
        self._rec_keys = []
        self._rec_parent = []
        self._rec_children = {}
        self._rec_sid_of = {}
        self._rec_roots = set()
        self._rec_costs = {}

    def _retire_active(self) -> None:
        """The active recording failed this iteration's structure: keep
        it in the cache (alternating patterns come back to it), clear
        the live replay state, and return to RECORDING."""
        if self.publish_priorities and \
                getattr(self.placement, "wants_replay_priorities", False):
            self.placement.clear_replay_priorities(scope=self._scope)
        self.replay_graph = None
        self._diverged = False
        self._div_buffers = {}
        self._div_buffered = 0
        self._iter_sid_of = {}
        self._iter_counts = []
        self._rec_counts = []
        self._iter_wds = []
        self._outstanding = []
        self._iter_started = False
        self._state = RECORDING
        self._reset_recording()

    # ------------------------------------------------------------------
    # remaining protocol: delegate, folding in replay-side state
    def idle_callback(self, worker_id: int) -> int:
        return self.inner.idle_callback(worker_id)

    def drain_all(self) -> int:
        return self.inner.drain_all()

    def flush(self, slot: int) -> None:
        self.inner.flush(slot)

    def pending(self) -> int:
        return self.inner.pending() + self._div_buffered

    def in_graph(self) -> int:
        return self.inner.in_graph() + self._live.value

    def stats(self) -> Dict[str, object]:
        st = dict(self.inner.stats())
        st["replay"] = {
            "state": self._state,
            "recordings": self.recordings,
            "replay_iterations": self.replay_iterations,
            "replayed_tasks": self.replayed_tasks,
            "invalidations": self.invalidations,
            "cache_hits": self.replay_cache_hits,
            "cached_recordings": len(self._cache),
            "recorded_tasks": (self.replay_graph.n
                               if self.replay_graph is not None else 0),
            "recorded_edges": (self.replay_graph.total_edges
                               if self.replay_graph is not None else 0),
        }
        return st
