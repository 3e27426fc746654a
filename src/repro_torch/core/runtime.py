"""Copy of `repro/core/runtime.py`.

Threaded task runtime: a thin thread-driver over a DependencePolicy.

The four dependence-management organizations (the paper's §6 comparison
set plus the sharded extension) live in ``core.engine.policy``:

  * ``sync``    — Nanos++ baseline: every worker mutates the dependence
                  graph directly under a global graph lock.
  * ``dast``    — the authors' earlier centralized design [7]: ONE
                  dedicated manager thread drains all queues.
  * ``ddast``   — this paper: no dedicated resources; idle workers become
                  managers through the Functionality Dispatcher.
  * ``sharded`` — beyond the paper: region-hash-partitioned graph shards
                  with per-shard mailboxes; idle workers claim whole
                  shards; optional Submit + Done batching
                  (``batch_size``).

With ``replay=True`` the chosen policy is wrapped in a
``ReplayPolicy`` (``engine/replay.py``): the first root-taskwait
iteration records the task structure, and structurally identical
re-submissions then skip dependence analysis, locks, and mailboxes
entirely (the Taskgraph record-and-replay optimization for iterative
workloads).

This module knows nothing about any of that: it owns the threads, the
thread-local task context, the taskwait protocol, and the stats
aggregation, and delegates every dependence action to ``self.policy``.
The same policy objects run unchanged under ``RuntimeSimulator`` in
virtual time, so sim-vs-real protocol divergence is structurally
impossible.

Scheduling is Distributed Breadth-First (paper §4, point 4): one ready
deque per worker with work stealing — lock-free two-lane ``StealDeque``s
(owner LIFO pop, thief FIFO steal, plus a banded priority lane) owned by
the ``PlacementPolicy`` from the scheduling subsystem (``core.sched``):
round-robin by default, shard-affine with ``placement="shard_affine"``,
and critical-path-over-frozen-replay-graphs with
``placement="critical_path"`` (+ ``replay=True``).

With ``num_clients=N`` the runtime is **multi-tenant**: ``open_scope``
returns a :class:`~repro_torch.core.scopes.JobScope` — an independent root
context with its own taskwait quiescence, its own dependence namespace
(the ``core.scopes`` region-keying shim), its own record-and-replay
slot, and a weighted-fair share of ready-task admission
(:class:`~repro_torch.core.scopes.FairAdmission` in front of the placement).
Client threads each own one submit slot, preserving the §3.1
single-producer queue discipline.

The runtime is instrumented with exactly the quantities the paper plots:
graph-lock wait time (per-shard waits summed under the sharded policy),
in-graph/ready task counts over time (Figs 12-14), message counts, and
task throughput.
"""
from __future__ import annotations

import itertools
import threading
import time
import traceback as _tb
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from .ddast import DDASTParams
from .dispatcher import FunctionalityDispatcher
from .engine import make_placement, make_policy, mode_uses_shards
from .errors import ScopeExpired, TaskFailed
from .metrics import NULL_METRICS, MetricsHub, MetricsSampler, SlotCounter
from .queues import InstrumentedLock
from .scopes import (FairAdmission, JobScope, ScopedPolicy, scope_rollup,
                     scoped_deps)
from .trace import (EV_CREATED, EV_END, EV_RETRY, EV_SCOPE_EXPIRED,
                    EV_START, IncrementalDetector, NULL_TRACER,
                    TraceEvent, TraceRecorder, replay_iterations_of)
from .wd import DepMode, TaskState, WorkDescriptor

_MODES = ("sync", "dast", "ddast", "sharded")

_tls = threading.local()


def _parse_deps(deps: Sequence[Tuple[Any, Union[str, DepMode]]]):
    out = []
    for region, mode in deps:
        if isinstance(mode, str):
            mode = DepMode(mode)
        out.append((region, mode))
    return tuple(out)


@dataclass
class RuntimeStats:
    tasks_executed: int = 0
    lock_acquisitions: int = 0
    lock_wait_s: float = 0.0           # sharded: per-shard waits summed
    messages_processed: int = 0        # sharded: per-shard counts summed
    ddast_callback_entries: int = 0
    max_in_graph: int = 0
    total_edges: int = 0
    trace: List[Tuple[float, int, int]] = field(default_factory=list)  # (t, in_graph, ready)
    # Per-task event timeline (core.trace; empty unless trace=True):
    # merged, time-sorted TraceEvents from every slot's ring buffer,
    # plus the count evicted by ring overflow.
    events: List[TraceEvent] = field(default_factory=list)
    trace_dropped: int = 0
    # Placement counters surfaced per run: steals FROM each slot's
    # deque, and shard-affine load-cap fallbacks (0 for placements
    # without the cap).
    worker_steals: List[int] = field(default_factory=list)
    load_cap_skips: int = 0
    wall_s: float = 0.0
    # Per-shard breakdowns (empty outside the sharded policy).
    shard_lock_wait_s: List[float] = field(default_factory=list)
    shard_messages: List[int] = field(default_factory=list)
    # Delegation/combining counters (sharded mode with delegation=True;
    # zero elsewhere). delegated_portions counts every dependence
    # portion published onto a shard's MPSC request list (structural —
    # identical between this driver and the simulator on the same
    # program); combined_drains counts combine sessions; the per-shard
    # handoff list counts post-release re-acquisitions by a combiner
    # that found new requests published behind its back.
    delegated_portions: int = 0
    combined_drains: int = 0
    shard_lock_handoffs: List[int] = field(default_factory=list)
    # Record-and-replay counters (zero unless replay=True).
    replay_iterations: int = 0         # iterations served fully by replay
    replayed_tasks: int = 0            # submits elided from live analysis
    replay_invalidations: int = 0      # recordings retired on divergence
    replay_cache_hits: int = 0         # recordings reused from the cache
    # Per-scope rollups (empty unless scopes were opened): scope name ->
    # {tasks, weight, iterations, wall_s, admitted, admission_waits,
    #  max_queued, replay_iterations, replayed_tasks}.
    scopes: Dict[str, dict] = field(default_factory=dict)
    # Process-backend IPC counters (zero under threads): ring frames
    # shipped each way (Submit batches, Done batches, control frames)
    # and the per-root-quiescence (submit, done) frame deltas — the
    # replay steady-state 0-message gate in bench_procs.py reads
    # ipc_iter.
    ipc_submit_msgs: int = 0
    ipc_done_msgs: int = 0
    ipc_ctrl_msgs: int = 0
    ipc_iter: List[Tuple[int, int]] = field(default_factory=list)
    # Fault-tolerance counters. Respawns, timeout kills, transport
    # errors, zombies and shm leaks are process-backend quantities;
    # retries/poisoned also count threaded body-error retries, and
    # scopes_expired counts deadline/budget expiries (threads).
    worker_respawns: int = 0
    task_retries: int = 0
    tasks_poisoned: int = 0
    timeout_kills: int = 0
    transport_errors: int = 0
    trace_lost: int = 0
    zombie_workers: int = 0
    leaked_shm: List[str] = field(default_factory=list)
    scopes_expired: int = 0
    # Final live-metrics snapshot (core.metrics; empty unless
    # metrics=True): the same structure rt.metrics() serves mid-run —
    # per-slot counters, latency histogram, sampled series, scope SLO.
    metrics: Dict[str, object] = field(default_factory=dict)


# Backward-compatible alias: the lock lives in queues.py so every layer
# can use it without circular imports.
_InstrumentedLock = InstrumentedLock


class TaskRuntime:
    """Host task runtime. Use as a context manager::

        with TaskRuntime(num_workers=4, mode="ddast") as rt:
            rt.task(f, a, b, deps=[(("A", 0), "inout")])
            rt.taskwait()
    """

    def __new__(cls, *args, backend: str = "threads", **kwargs):
        # Backend dispatch: ``TaskRuntime(backend="processes")`` builds
        # the multi-process sibling driver (core.procs). ProcessRuntime
        # is deliberately NOT a subclass — it returns fully constructed
        # from here, so this __init__ never runs on it and the two
        # drivers cannot half-share thread state by accident.
        if cls is TaskRuntime and backend == "processes":
            from .procs import ProcessRuntime
            return ProcessRuntime(*args, backend=backend, **kwargs)
        return super().__new__(cls)

    def __init__(self, num_workers: int = 4, mode: str = "ddast",
                 params: Optional[DDASTParams] = None,
                 trace: bool = False,
                 manager_eligible: Optional[set] = None,
                 num_shards: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 placement: Any = "round_robin",
                 replay: bool = False,
                 num_clients: int = 0,
                 delegation: bool = True, *,
                 backend: str = "threads",
                 metrics: bool = False,
                 metrics_interval_s: float = 0.002) -> None:
        # keyword-only on purpose: __new__ dispatches on the *keyword*
        # backend, so a positional value would silently select the
        # threaded driver — make that a TypeError instead
        if backend not in ("threads", "processes"):
            raise ValueError("backend must be 'threads' or 'processes'")
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}")
        if num_shards is not None and num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if num_clients < 0:
            raise ValueError("num_clients must be >= 0")
        self.num_workers = num_workers
        self.mode = mode
        self.params = params or DDASTParams()
        self.trace_enabled = trace
        self.manager_eligible = manager_eligible
        self.num_shards = num_shards or max(2, num_workers)
        self.batch_size = batch_size
        self.replay = replay
        self.num_clients = num_clients
        self.delegation = delegation

        # +1: the main thread's slot; client threads (multi-tenant
        # scopes) each own one more so the single-producer submit-queue
        # discipline (§3.1) survives concurrent tenants
        num_slots = num_workers + 1 + num_clients
        # the event tracer must exist before the policy stack: the
        # policy ctor wires it into the placement, the router, etc.
        self._trace_t0 = time.perf_counter()
        self.tracer = TraceRecorder(
            num_slots, clock=lambda: time.perf_counter() - self._trace_t0,
            time_unit="s") if trace else NULL_TRACER
        # shard-id affinity keying only makes sense over a shard
        # partition; other modes keep exact-region keying
        self.placement = make_placement(
            placement, num_slots,
            num_shards=self.num_shards if mode_uses_shards(mode) else None)
        if num_clients > 0:
            # multi-tenant: fair admission in front of the deques; the
            # scope multiplexer below owns the replay wrapping (one
            # recording slot per scope), so the base policy stays live
            self.placement = FairAdmission(self.placement)
        self.policy: Any = make_policy(
            mode, num_slots,
            num_workers=num_workers,
            params=self.params,
            placement=self.placement,
            manager_eligible=manager_eligible,
            main_slot=num_workers,
            num_shards=self.num_shards,
            batch_size=batch_size,
            delegation=delegation,
            replay=replay and num_clients == 0,
            tracer=self.tracer)
        if num_clients > 0:
            self.policy = ScopedPolicy(self.policy, replay=replay)
        self.dispatcher = FunctionalityDispatcher()
        if self.policy.uses_idle_managers:
            self.dispatcher.register("policy", self.policy.callback,
                                     priority=10)
        # live metrics plane (core.metrics): per-slot instruments on
        # the task path, sampler as ONE MORE idle/quiescent callback —
        # per DDAST discipline, idle threads take the samples
        self.metrics_enabled = metrics
        self.instruments = MetricsHub(
            num_slots,
            clock=lambda: time.perf_counter() - self._trace_t0,
            time_unit="s") if metrics else NULL_METRICS
        self.sampler: Optional[MetricsSampler] = None
        if metrics:
            self.sampler = MetricsSampler(
                clock=lambda: time.perf_counter() - self._trace_t0,
                interval=metrics_interval_s,
                tracer=self.tracer if trace else None,
                detector=IncrementalDetector() if trace else None)
            self._register_probes()
            self.dispatcher.register("metrics-sampler",
                                     self.sampler.callback, priority=1)
            self.dispatcher.register_quiescent(
                "metrics-sampler", self.sampler.quiescent_callback,
                priority=2)

        # always on, beside the optional plane above: each time a worker
        # finds no task and offers itself to the dispatcher, one store on
        # its own slot (the port's own; not a `RuntimeStats` field, which
        # stay the JAX package's)
        self.idle_polls = SlotCounter(num_slots)

        self._root = WorkDescriptor(func=None, label="main")
        self._root.state = TaskState.RUNNING
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._manager_thread: Optional[threading.Thread] = None
        self.stats = RuntimeStats()
        self._trace_t0 = time.perf_counter()
        # multi-tenant bookkeeping (inert when num_clients == 0)
        self._scopes: List[JobScope] = []
        self._scope_seq = itertools.count(1)
        self._main_thread = threading.current_thread()
        self._client_slot_lock = threading.Lock()
        self._free_client_slots = list(range(num_workers + 1, num_slots))
        self._client_slot_of: Dict[int, int] = {}   # thread ident -> slot
        self._client_slot_refs: Dict[int, int] = {}  # slot -> open scopes
        # per-scope failure isolation: body errors keyed by the failing
        # task's scope (None = the default root context) and raised only
        # from that scope's taskwait — one tenant's crash never surfaces
        # in another tenant's wait
        self._task_errors: Dict[Optional[int],
                                List[Tuple[str, str, list]]] = {}
        self._error_lock = threading.Lock()
        self._scope_by_id: Dict[int, JobScope] = {}
        self._retry_count = 0
        self._poisoned_count = 0

    # ------------------------------------------------------------------
    # historical accessors (the policy owns the structures now)
    @property
    def ddast(self):
        """The manager-side policy object (historically a DDASTManager)."""
        return self.policy

    @property
    def worker_queues(self):
        return getattr(self.policy, "worker_queues", [])

    @property
    def shard_router(self):
        return getattr(self.policy, "router", None)

    @property
    def shard_graph(self):
        return getattr(self.policy, "graph", None)

    # ------------------------------------------------------------------
    # lifecycle
    def __enter__(self) -> "TaskRuntime":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    def start(self) -> None:
        self._trace_t0 = time.perf_counter()
        self._main_thread = threading.current_thread()
        _tls.current = self._root
        _tls.worker_id = self.num_workers  # main thread owns the last slot
        for i in range(self.num_workers):
            t = threading.Thread(target=self._worker_loop, args=(i,),
                                 name=f"worker-{i}", daemon=True)
            self._threads.append(t)
            t.start()
        if self.policy.needs_manager_thread:
            self._manager_thread = threading.Thread(
                target=self._manager_loop, name="manager", daemon=True)
            self._manager_thread.start()

    def shutdown(self) -> None:
        # scope roots are NOT children of the runtime root: drain every
        # still-open tenant before the final root taskwait (close() is
        # a no-op for scopes the client already closed). A failing
        # tenant must not abort the teardown of the others: collect the
        # first error, finish draining and joining, then re-raise.
        err: Optional[BaseException] = None
        for sc in self._scopes:
            try:
                sc.close()
            except (TaskFailed, ScopeExpired) as e:
                if err is None:
                    err = e
        try:
            self.taskwait()
        except (TaskFailed, ScopeExpired) as e:
            if err is None:
                err = e
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._manager_thread is not None:
            self._manager_thread.join(timeout=5.0)
        self.stats.wall_s = time.perf_counter() - self._trace_t0
        self.stats.ddast_callback_entries = self.policy.callback_entries
        st = self.policy.stats()
        self.stats.messages_processed = st["messages_processed"]
        self.stats.lock_acquisitions = st["lock_acquisitions"]
        self.stats.lock_wait_s = st["lock_wait_s"]
        self.stats.max_in_graph = st["max_in_graph"]
        self.stats.total_edges = st["total_edges"]
        self.stats.shard_messages = st["shard_messages"]
        self.stats.shard_lock_wait_s = st["shard_lock_wait_s"]
        self.stats.delegated_portions = st["delegated_portions"]
        self.stats.combined_drains = st["combined_drains"]
        self.stats.shard_lock_handoffs = list(st["shard_lock_handoffs"])
        pst = self.placement.stats()
        self.stats.worker_steals = [d.stolen for d in self.placement.deques]
        self.stats.load_cap_skips = int(pst.get("load_cap_skips", 0))
        if self.tracer.enabled:
            self.stats.events = self.tracer.events()
            self.stats.trace_dropped = self.tracer.dropped
        rep = st.get("replay")
        if rep:
            self.stats.replay_iterations = rep["replay_iterations"]
            self.stats.replayed_tasks = rep["replayed_tasks"]
            self.stats.replay_invalidations = rep["invalidations"]
            self.stats.replay_cache_hits = rep["cache_hits"]
        scope_tasks = st.get("scope_tasks", {})
        for sc in self._scopes:
            entry = {"tasks": scope_tasks.get(sc.scope_id, 0),
                     "weight": sc.weight,
                     "iterations": sc.iterations,
                     "wall_s": sc.wall_s}
            entry.update(scope_rollup(self.placement, self.policy,
                                      sc.scope_id, scope=sc))
            if sc._expired_reason is not None:
                entry["expired"] = sc._expired_reason
                entry["budget_used_s"] = sc._budget_used
            self.stats.scopes[sc.name] = entry
        self.stats.task_retries += self._retry_count
        self.stats.tasks_poisoned += self._poisoned_count
        if self.metrics_enabled:
            self.stats.metrics = self.metrics()
        if err is not None:
            raise err

    # ------------------------------------------------------------------
    # ready pool / occupancy probes (delegated)
    def ready_count(self) -> int:
        return self.placement.ready_count()

    def in_graph_count(self) -> int:
        return self.policy.in_graph()

    def _pending_msgs(self) -> int:
        return self.policy.pending()

    def _sample_trace(self) -> None:
        if self.trace_enabled:
            self.stats.trace.append((time.perf_counter() - self._trace_t0,
                                     self.in_graph_count(),
                                     self.ready_count()))

    # ------------------------------------------------------------------
    # live metrics plane (core.metrics)
    def _register_probes(self) -> None:
        """Wire the sampler's derived series to read-only runtime
        probes. Every probe is lock-free (plain len()/int reads), so a
        sampling pass never contends with the task path."""
        s = self.sampler
        pl = self.placement
        hub = self.instruments
        W = self.num_workers

        def ready_depth():
            return {str(i): len(d) for i, d in enumerate(pl.deques)}

        s.add_probe("ready", pl.ready_count)
        s.add_probe("ready_depth", ready_depth)
        s.add_probe("pending_msgs", self.policy.pending)
        s.add_probe("in_graph", self.policy.in_graph)
        s.add_probe("busy_frac", lambda: hub.busy_fraction(W))
        if isinstance(pl, FairAdmission):
            s.add_probe("admission_backlog", pl.admission_backlog)
            s.add_probe("admission_waits", pl.admission_waits_total)
            s.add_probe("scope_inflight",
                        lambda: {str(k): v
                                 for k, v in pl.scope_inflight().items()})
        router = getattr(self.policy, "router", None) \
            or getattr(getattr(self.policy, "inner", None), "router", None)
        if router is not None:
            s.add_probe("delegated_portions",
                        lambda: router.delegated_portions)
            s.add_probe("combined_drains", lambda: router.combined_drains)

    def metrics(self) -> Dict[str, object]:
        """Structured live snapshot: instrument counters + latency
        histogram, point-in-time gauges, per-scope inflight/admission/
        SLO entries, and the sampler's time-series rings. Callable at
        any time — including while a run is in flight — and frozen into
        ``stats.metrics`` at shutdown."""
        snap: Dict[str, object] = dict(self.instruments.snapshot()) \
            if self.metrics_enabled else {"time_unit": "s"}
        pl = self.placement
        gauges: Dict[str, object] = {
            "ready": pl.ready_count(),
            "pending_msgs": self.policy.pending(),
            "in_graph": self.policy.in_graph(),
        }
        if self.metrics_enabled:
            gauges["busy_frac"] = \
                self.instruments.busy_fraction(self.num_workers)
        if isinstance(pl, FairAdmission):
            gauges["admission_backlog"] = pl.admission_backlog()
            gauges["admission_waits"] = pl.admission_waits_total()
        snap["gauges"] = gauges
        if self._scopes:
            inflight = pl.scope_inflight() \
                if isinstance(pl, FairAdmission) else {}
            entries: Dict[str, object] = {}
            for sc in self._scopes:
                e: Dict[str, object] = {
                    "inflight": inflight.get(sc.scope_id, 0),
                    "tasks_alive": sc.root.num_children_alive,
                }
                adm = getattr(pl, "scope_admission", None)
                if callable(adm):
                    try:
                        e["admission"] = adm(sc.scope_id)
                    except KeyError:    # pragma: no cover - defensive
                        pass
                slo = sc.slo_snapshot()
                if slo is not None:
                    e["slo"] = slo
                entries[sc.name] = e
            snap["scopes"] = entries
        if self.sampler is not None:
            snap["sampler"] = self.sampler.snapshot()
        return snap

    # ------------------------------------------------------------------
    # public task API
    def task(self, func: Callable[..., Any], *args,
             deps: Sequence[Tuple[Any, Union[str, DepMode]]] = (),
             label: str = "task", retries: int = 0,
             timeout: Optional[float] = None) -> WorkDescriptor:
        """Create + submit a task (life-cycle steps 1-2). ``retries=N``
        re-runs a body that raises up to N times before the error is
        recorded (at-least-once: retried bodies must be idempotent);
        exhausted retries surface as :class:`TaskFailed` at the owning
        scope's taskwait. ``timeout=`` is advisory under threads (a
        thread cannot be killed mid-body); the process backend enforces
        it by killing and respawning the stuck worker."""
        parent = getattr(_tls, "current", None) or self._root
        return self._submit_task(parent, func, args, deps, label,
                                 retries=retries, timeout=timeout)

    def _submit_task(self, parent: WorkDescriptor, func, args, deps,
                     label: str, retries: int = 0,
                     timeout: Optional[float] = None) -> WorkDescriptor:
        # the ONE keying shim (core.scopes): a task created under a
        # scope declares scope-qualified regions, so tenants can never
        # alias each other's keys anywhere downstream
        wd = WorkDescriptor(func=func, args=args,
                            deps=_parse_deps(scoped_deps(parent.scope,
                                                         deps)),
                            label=label, parent=parent,
                            retries=max(0, retries), timeout=timeout)
        wid = self._current_wid()
        if self.tracer.enabled:
            self.tracer.task_event(EV_CREATED, wd, wid)
        self.policy.submit(wd, wid)
        self._sample_trace()
        return wd

    def taskwait(self) -> None:
        """Block until all children of the current task completed. The
        blocked thread keeps working: executes ready tasks and runs the
        registered idle callbacks — the paper's idle-thread philosophy."""
        self._taskwait_on(getattr(_tls, "current", None) or self._root)

    def _taskwait_on(self, parent: WorkDescriptor) -> None:
        wid = self._current_wid()
        scope_root = getattr(parent, "is_scope_root", False)
        if scope_root:
            # a tenant quiescence edge flushes EVERY slot (cross-thread
            # flush is lock-protected in the batching policy, same as
            # drain_all): the scope's buffered submits may sit in a
            # departed client thread's buffer that no idle callback
            # will ever flush — without this, close()/shutdown() on an
            # abandoned scope would spin forever on its unshipped
            # children
            for s in range(self.num_workers + 1 + self.num_clients):
                self.policy.flush(s)
        else:
            self.policy.flush(wid)
        root = parent is self._root or scope_root
        sid = parent.scope if scope_root else None
        # Scoped waiters gate on their own subtree alone: every child —
        # including one whose Submit is still queued, buffered, or in a
        # replay divergence buffer — incremented num_children_alive at
        # CREATION and only decrements once its Done is fully processed,
        # so children == 0 already implies nothing of THIS scope is in
        # flight. Gating on the runtime-wide pending count here would
        # let a busy tenant delay another tenant's quiescence (and
        # replay freeze) unboundedly. The default (scope-less) context
        # keeps the global probe: its taskwait doubles as the runtime's
        # drain point at shutdown.
        scoped = parent.scope is not None
        while True:
            if parent.num_children_alive == 0 and \
                    (scoped or not self._pending_msgs()):
                # policy first (a replay wrapper freezes/validates its
                # recording here), then dispatcher callbacks (the tuner
                # may resize shards — legal only once the policy has
                # settled its iteration state). A scope quiescence is
                # NOT global quiescence, so it routes to the scope's
                # policy slot only and skips the dispatcher hooks.
                self.policy.notify_quiescent(root, scope_id=sid)
                if root and self.tracer.enabled:
                    # the boundary payload lets trace consumers tell
                    # replayed windows (manager-silent by design) from
                    # live ones
                    self.tracer.quiesce(
                        {"scope": sid,
                         "replay_iterations": replay_iterations_of(
                             self.policy, sid)})
                if not scope_root:
                    self.dispatcher.notify_quiescent(wid)
                if root:
                    self._raise_wait_errors(sid, scope_root)
                return
            wd = self.placement.pop(wid)
            if wd is not None:
                self._execute(wd, wid)
                continue
            self.dispatcher.notify_idle(wid)
            time.sleep(self.policy.idle_sleep_s)

    # ------------------------------------------------------------------
    # multi-tenant scope API (core.scopes)
    def open_scope(self, name: Optional[str] = None, *,
                   weight: float = 1.0,
                   max_inflight: Optional[int] = None,
                   deadline: Optional[float] = None,
                   budget: Optional[float] = None) -> JobScope:
        """Open an independent root context for one tenant. Requires a
        multi-tenant runtime (``num_clients >= 1``): client threads each
        own a submit slot there, and the scope layers (per-scope replay
        slots + fair admission) are in place.

        ``deadline=`` (wall seconds from open) and ``budget=`` (summed
        body-execution seconds) bound the scope: once either expires,
        FairAdmission drains the scope's queued tasks unrun and the
        scope's own taskwait raises :class:`ScopeExpired` — other
        tenants are untouched."""
        if self.num_clients <= 0:
            raise ValueError(
                "open_scope needs TaskRuntime(num_clients=N): client "
                "submit slots and the scope layers are sized at "
                "construction")
        slot = self._ensure_client_slot()
        sid = next(self._scope_seq)
        sc = JobScope(self, sid, name or f"scope{sid}",
                      weight=weight, max_inflight=max_inflight,
                      deadline=deadline, budget=budget)
        if slot > self.num_workers:     # an allocated client slot:
            sc._client_slot = slot      # returned once the owning
            with self._client_slot_lock:  # thread's last scope closes
                self._client_slot_refs[slot] = \
                    self._client_slot_refs.get(slot, 0) + 1
        self.policy.register_scope(sid)
        self.placement.register_scope(sid, weight, max_inflight,
                                      expired_fn=sc.is_expired)
        self._scopes.append(sc)
        self._scope_by_id[sid] = sc
        return sc

    def _release_client_slot(self, scope: JobScope) -> None:
        """A scope closed: when it was the owning client thread's last
        open scope, recycle the thread's submit slot so tenant-session
        churn (thread per session) is bounded by CONCURRENT clients,
        not total ones. Safe at close time: the scope quiesced, so the
        slot's queues and buffers hold nothing of it."""
        slot = getattr(scope, "_client_slot", None)
        if slot is None:
            return
        scope._client_slot = None
        with self._client_slot_lock:
            refs = self._client_slot_refs.get(slot, 0) - 1
            if refs > 0:
                self._client_slot_refs[slot] = refs
                return
            self._client_slot_refs.pop(slot, None)
            for ident, s in list(self._client_slot_of.items()):
                if s == slot:
                    del self._client_slot_of[ident]
            self._free_client_slots.append(slot)

    def _scope_task(self, scope: JobScope, func, args, deps,
                    label: str, retries: int = 0,
                    timeout: Optional[float] = None) -> WorkDescriptor:
        cur = getattr(_tls, "current", None)
        parent = (cur if cur is not None
                  and getattr(cur, "scope", None) == scope.scope_id
                  else scope.root)
        return self._submit_task(parent, func, args, deps, label,
                                 retries=retries, timeout=timeout)

    def _scope_taskwait(self, scope: JobScope) -> None:
        self._taskwait_on(scope.root)

    def _enter_scope(self, scope: JobScope) -> None:
        """``with scope:`` — the calling thread's submissions land in
        the scope until exit (per-thread stack, so scopes nest)."""
        stack = getattr(_tls, "scope_stack", None)
        if stack is None:
            stack = _tls.scope_stack = []
        stack.append(getattr(_tls, "current", None))
        _tls.current = scope.root

    def _exit_scope(self, scope: JobScope) -> None:
        del scope
        prev = _tls.scope_stack.pop()
        if prev is None:
            try:
                del _tls.current
            except AttributeError:  # pragma: no cover - defensive
                pass
        else:
            _tls.current = prev

    def _ensure_client_slot(self) -> int:
        """The calling thread's submit slot, allocating a client slot
        for threads the runtime doesn't already own (cold path: once
        per thread per runtime; recycled by ``_release_client_slot``)."""
        wid = self._client_slot_of.get(threading.get_ident())
        if wid is not None:
            return wid
        t = threading.current_thread()
        if t is self._main_thread or t in self._threads:
            return self._current_wid()  # already owns a slot
        with self._client_slot_lock:
            wid = self._client_slot_of.get(threading.get_ident())
            if wid is not None:
                return wid
            if not self._free_client_slots:
                raise RuntimeError(
                    f"no free client slot (num_clients={self.num_clients}"
                    f"): raise num_clients or reuse a registered thread")
            wid = self._free_client_slots.pop(0)
            self._client_slot_of[threading.get_ident()] = wid
        return wid

    def _current_wid(self) -> int:
        """This thread's worker id, clamped to this runtime's slots: the
        TLS is module-global, so a thread that last belonged to a larger
        runtime would otherwise index out of range here. Registered
        client threads (multi-tenant scopes) resolve through this
        runtime's slot map first (GIL-atomic dict read)."""
        wid = self._client_slot_of.get(threading.get_ident())
        if wid is not None:
            return wid
        wid = getattr(_tls, "worker_id", self.num_workers)
        return wid if wid <= self.num_workers else self.num_workers

    # ------------------------------------------------------------------
    # execution
    def _execute(self, wd: WorkDescriptor, worker_id: int) -> None:
        prev_task = getattr(_tls, "current", self._root)
        prev_wid = getattr(_tls, "worker_id", self.num_workers)
        _tls.current, _tls.worker_id = wd, worker_id
        wd.mark_running()
        tr = self.tracer
        m = self.instruments
        if m.enabled:
            m.task_start(worker_id)
        if tr.enabled:
            tr.task_event(EV_START, wd, worker_id)
        t0 = time.perf_counter()
        executed = False
        try:
            # a raising body must NOT kill the worker thread (that hung
            # every later taskwait): capture it, retry in place while
            # retries remain, then record it against the owning scope
            while wd.func is not None and not wd.cancelled:
                try:
                    wd.result = wd.func(*wd.args)
                    executed = True
                    break
                except Exception:
                    if wd.retries_left > 0:
                        # attempt history records RETRIED attempts only
                        # (the terminal failure is the traceback itself
                        # — same convention as the process backend)
                        wd.attempts.append(
                            {"worker": worker_id, "reason": "error",
                             "t": time.perf_counter() - self._trace_t0})
                        wd.retries_left -= 1
                        self._retry_count += 1
                        if tr.enabled:
                            tr.task_event(
                                EV_RETRY, wd, worker_id,
                                {"attempt": len(wd.attempts),
                                 "reason": "error"})
                        continue
                    self._poisoned_count += 1
                    with self._error_lock:
                        self._task_errors.setdefault(
                            wd.scope, []).append(
                                (wd.label, _tb.format_exc(),
                                 list(wd.attempts)))
                    break
        finally:
            # measured body time feeds the replay scheduler's cost EMA
            wd.exec_dur = time.perf_counter() - t0
            wd.mark_finished()
            _tls.current, _tls.worker_id = prev_task, prev_wid
        if m.enabled:
            m.task_end(worker_id, wd.exec_dur)
        self._charge_scope(wd, worker_id)
        if tr.enabled:
            # end BEFORE complete(): successors' ready events must sort
            # after their predecessor's end
            tr.task_event(EV_END, wd, worker_id)
        if executed or wd.func is None:
            self.stats.tasks_executed += 1
        self.placement.note_executed(wd, worker_id)
        self.policy.complete(wd, worker_id)
        self._sample_trace()

    def _charge_scope(self, wd: WorkDescriptor, slot: int = -1) -> None:
        """Charge a finished body against its scope's execution-time
        budget, record its SLO outcome (deadline scopes), and fire the
        expiry transition the first time the scope is seen expired."""
        if wd.scope is None:
            return
        sc = self._scope_by_id.get(wd.scope)
        if sc is None:
            return
        if not wd.cancelled:
            sc._budget_used += wd.exec_dur
        if sc.deadline is not None:
            sc.note_completion(slot,
                               time.perf_counter() - sc.opened_s,
                               cancelled=wd.cancelled)
        if sc.is_expired():
            self._note_expiry(sc)

    def _note_expiry(self, sc: JobScope) -> None:
        """Record a scope's deadline/budget expiry exactly once (stats
        counter + trace event); safe to call repeatedly."""
        if sc._expiry_traced:
            return
        sc._expiry_traced = True
        self.stats.scopes_expired += 1
        if self.tracer.enabled:
            self.tracer.mgr_event(
                EV_SCOPE_EXPIRED, self._current_wid(),
                {"scope": sc.scope_id, "name": sc.name,
                 "reason": sc._expired_reason})

    def _raise_wait_errors(self, sid: Optional[int],
                           scope_root: bool) -> None:
        """Surface failures at the owning wait only: a scope taskwait
        raises its own scope's errors (ScopeExpired once, then any
        TaskFailed); the default root taskwait raises only scope-less
        task errors. One tenant's failure never escapes into another
        tenant's — or the root's — wait."""
        if scope_root:
            sc = self._scope_by_id.get(sid)
            if sc is not None and sc.is_expired() \
                    and not sc._expiry_raised:
                sc._expiry_raised = True
                self._note_expiry(sc)
                with self._error_lock:
                    self._task_errors.pop(sid, None)
                raise ScopeExpired(
                    f"scope {sc.name!r} expired ({sc._expired_reason}); "
                    f"{sc.drained} queued task(s) drained unrun",
                    scope=sc.name, reason=sc._expired_reason,
                    drained=sc.drained)
        with self._error_lock:
            errors = self._task_errors.pop(sid, None)
        if not errors:
            return
        label, tb, attempts = errors[0]
        more = f" (+{len(errors) - 1} more)" if len(errors) > 1 else ""
        att = f" after {len(attempts)} attempt(s)" if attempts else ""
        where = "" if sid is None else " in its scope"
        raise TaskFailed(f"task {label!r} raised{where}{att}{more}:\n{tb}",
                         failures=errors)

    def _worker_loop(self, worker_id: int) -> None:
        _tls.current = self._root
        _tls.worker_id = worker_id
        polls = self.idle_polls.per_slot
        while not self._stop.is_set():
            wd = self.placement.pop(worker_id)
            if wd is not None:
                self._execute(wd, worker_id)
                continue
            polls[worker_id] += 1
            # the test here, not inside _sample_trace: an untraced poll
            # makes no method call
            if self.dispatcher.notify_idle(worker_id) and self.trace_enabled:
                self._sample_trace()
            time.sleep(0)                   # yield (busy-wait analogue)

    def _manager_loop(self) -> None:
        """Dedicated manager thread (the authors' previous design [7]);
        spawned only when the policy asks for one."""
        while not self._stop.is_set():
            if self.policy.drain_all() == 0:
                time.sleep(1e-6)
