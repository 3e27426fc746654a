"""Copy of `repro/core/simulator.py`.

Deterministic discrete-event simulator of the task runtime.

The JAX package's host exposed ONE physical core, so the paper's
headline results (speedup vs. 16-64 worker threads, Figs 9-11) could
not be measured with real threads there. The simulator reproduces them
in *virtual time*: N virtual cores, task durations in microseconds,
critical sections serialized on virtual locks.

Since the unified dependence-policy engine (``core.engine``), the
simulator does NOT re-implement the dependence protocol: it drives the
*same* ``DependencePolicy`` objects the threaded ``TaskRuntime`` uses
(``SyncPolicy`` / ``DastPolicy`` / ``DdastPolicy`` / ``ShardedPolicy``
over the real ``DependenceGraph`` / ``ShardedDependenceGraph`` /
``ShardRouter`` structures), installing a
:class:`~repro_torch.core.engine.charge.SimCharger` so every protocol step is
priced in virtual time: critical sections serialize on one
:class:`~repro_torch.core.engine.charge.VirtualLock` per lock key
(FIFO-handover approximation), every mailbox entry costs one
``msg_overhead`` (a Submit *batch* therefore costs one, which is the
point of batching), and sharded portions cost
``submit_cs / k + portion_overhead`` each. Message counts and dependence
orderings are therefore identical to the threaded runtime by
construction, not by parallel maintenance.

Cost constants default to the reference's values, calibrated from the
JAX package's threaded runtime on that package's CPU host (its
``benchmarks/bench_contention.py``, whose ``--calibrate`` flag measures
``portion_overhead``), and can be overridden. They are virtual
microseconds of that host: none of them is a time measured on a GPU,
nor a cost of the port's runtime. The cache-pollution effect the paper
measures (§6.1: task bodies ~33 % faster under DDAST because workers
stop touching runtime structures between tasks) is modeled by the
charger: a virtual-lock acquisition flags the acting core, and the next
task body it executes is charged a duration multiplier.

``run(specs, iterations=n)`` re-submits the same graph n times with a
root taskwait between iterations (the paper's epoch loop) and reports
per-iteration makespan/lock/message deltas; with ``replay=True`` the
policy is wrapped in the record-and-replay ``ReplayPolicy``, whose
steady-state iterations are priced as pure latch arithmetic (no
VirtualLock, no message, no pollution flag).

Everything is deterministic: no wall clock, no randomness — identical
inputs give identical makespans (required for hypothesis-based testing).
One approximation is accepted relative to a fully causal event model:
state produced while a core's local clock runs ahead (inside a lock
wait) becomes visible to other cores at their next event rather than at
the exact virtual instant; waits themselves are always charged in full.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .ddast import DDASTParams
from .engine import (SimCharger, make_placement, make_policy,
                     mode_needs_manager_thread, mode_uses_shards)
from .metrics import NULL_METRICS, MetricsHub, MetricsSampler
from .scopes import (FairAdmission, ScopedPolicy, scope_rollup,
                     scoped_deps)
from .trace import (EV_CREATED, EV_END, EV_START, NULL_TRACER,
                    TraceRecorder, replay_iterations_of)
from .wd import DepMode, TaskState, WorkDescriptor

# ---------------------------------------------------------------------------


@dataclass
class SimTaskSpec:
    """One task in virtual time. `deps` = (region, DepMode) pairs; `dur` in
    microseconds; `children` makes this a nesting parent (N-Body style):
    the executing core creates the children, taskwaits on them (working as
    a normal worker meanwhile), then the parent completes."""
    dur: float
    deps: Sequence[Tuple[Any, DepMode]] = ()
    children: Optional[List["SimTaskSpec"]] = None
    label: str = "t"


@dataclass
class SimCosts:
    """Virtual-time costs (µs). The defaults are the reference's,
    calibrated on the JAX package's CPU host (its EXPERIMENTS.md
    §Paper/contention); no default is a time of a GPU."""
    create: float = 3.1        # WD alloc + arg capture (measured: 3.15us)
    push: float = 0.08         # SPSC queue push (measured: 0.076us)
    submit_cs: float = 2.0     # graph insert critical section (base)
    submit_cs_dep: float = 0.8    # ... plus this per declared dependence
    done_cs: float = 1.0       # graph completion critical section (base)
    done_cs_dep: float = 0.5   # ... plus this per dependence scrubbed
    msg_overhead: float = 0.25  # manager pop+dispatch per mailbox entry
    portion_overhead: float = 0.35  # fixed cost per shard portion (latch
    #   arithmetic + per-shard dispatch; measured by
    #   bench_contention.py --calibrate, replacing the idealized
    #   submit_cs / k split)
    lock_overhead: float = 0.12  # uncontended acquire/release
    pollution: float = 1.25    # duration multiplier after graph ops (§6.1)
    # Record-and-replay steady-state steps (engine/replay.py): a Submit
    # is a structural-key check + one latch decrement, a Done is one
    # latch decrement per recorded successor — no lock, no message, and
    # no pollution flag (the replay path touches no shared runtime
    # structures, which is how the §6.1 cache win compounds).
    replay_submit: float = 0.12  # key compare + submit-phase latch dec
    replay_done: float = 0.05    # completion bookkeeping (fixed part)
    replay_dec: float = 0.04     # per recorded successor latch dec
    # Critical-path placement lane traffic (sched/placement.py): a
    # priority push is one banded deque append, a pop pays the band
    # scan — both lock-free, priced so the critical_path-vs-round_robin
    # makespan comparison in bench_sched.py is honest.
    prio_push: float = 0.06      # banded append + band lookup
    prio_pop: float = 0.04       # pop-side band scan while replaying
    # One tracing ring-buffer append (core.trace, trace=True only):
    # a tuple build + GIL-atomic deque append. Priced so the
    # traced-vs-untraced overhead gate in bench_traces.py measures a
    # real cost instead of zero by construction.
    trace_event: float = 0.05
    # Cross-process mailbox traffic (core.procs ring buffers), so the
    # simulator can model backend="processes" before buying cores: one
    # Submit batch encoded + pushed onto an exec ring, and one Done
    # batch popped + decoded off a done ring. Measure on the current
    # host with ``bench_contention.py --calibrate`` (real shm-ring
    # round-trips against an echo process).
    ipc_submit_us: float = 12.0  # encode_submit_batch + ring push
    ipc_done_us: float = 8.0     # ring pop + decode_done_batch
    # Delegation/combining fast path (shards.router): publishing one
    # message onto a shard's MPSC request list (a GIL-atomic deque
    # append + one trylock attempt), and one combine-session fixed cost
    # on the lock-holder side (staging the drained requests into
    # per-scope buckets). Measure with ``bench_contention.py
    # --calibrate`` (delegate row = publish+trylock on a held lock).
    delegate_us: float = 0.18    # request-list append + failed trylock
    combine_us: float = 0.30     # per combine session (staging/rotation)
    # Live metrics plane (core.metrics, metrics=True only): one per-slot
    # instrument write (counter bump / histogram bucket increment) per
    # task start and per task end, and one sampler pass (probe walk +
    # series appends) per sampling interval. Priced so the
    # metrics-overhead gate in bench_metrics.py measures a real cost.
    metric_event: float = 0.02   # per-slot counter/histogram write
    metric_sample: float = 0.8   # one probe-walk sampling pass


@dataclass
class SimResult:
    makespan_us: float
    serial_us: float
    tasks: int
    lock_wait_us: float = 0.0
    lock_acquisitions: int = 0
    messages: int = 0
    max_in_graph: int = 0
    total_edges: int = 0
    trace: List[Tuple[float, int, int]] = field(default_factory=list)
    # Per-task event timeline (core.trace; empty unless trace=True),
    # same schema as RuntimeStats.events with virtual-µs timestamps.
    events: list = field(default_factory=list)
    trace_dropped: int = 0
    # Placement counters surfaced per run (see RuntimeStats).
    worker_steals: List[int] = field(default_factory=list)
    load_cap_skips: int = 0
    exec_order: List[str] = field(default_factory=list)  # task labels
    # Per-iteration breakdown when run(..., iterations=n): virtual time,
    # lock acquisitions, and mailbox entries attributable to each
    # iteration (deltas between root-quiescence boundaries). Under a
    # frozen replay recording the steady-state entries are 0 locks and
    # 0 messages — the quantity bench_replay.py gates on.
    iterations: int = 1
    iter_makespans_us: List[float] = field(default_factory=list)
    iter_lock_acq: List[int] = field(default_factory=list)
    iter_messages: List[int] = field(default_factory=list)
    # Delegation/combining counters (sharded mode; zero elsewhere or
    # with delegation=False). delegated_portions is structural — every
    # portion that traversed a shard request list — so the threaded
    # driver and the simulator report identical values on the same
    # program (extends the sim-vs-real identity tests).
    delegated_portions: int = 0
    combined_drains: int = 0
    lock_handoffs: List[int] = field(default_factory=list)
    # Per-scope rollups when run_scopes(...) drove multiple tenant
    # programs: scope name -> {tasks, weight, finish_us,
    # iter_makespans_us, replay_iterations, replayed_tasks, admitted,
    # admission_waits, max_queued}. Only per-scope-attributable
    # quantities appear here — lock/message counters are runtime-wide
    # (compare iterations=1 vs iterations=n runs to bound replay cost).
    scopes: Dict[str, dict] = field(default_factory=dict)
    # Live-metrics snapshot (core.metrics; empty unless metrics=True):
    # per-slot counters, virtual-µs latency histogram, sampled series —
    # the same structure RuntimeStats.metrics carries on real threads.
    metrics: Dict[str, object] = field(default_factory=dict)

    @property
    def speedup(self) -> float:
        return self.serial_us / self.makespan_us if self.makespan_us else 0.0


# ---------------------------------------------------------------------------


class _SimProgram:
    """One client program driven by the event loop: a spec graph
    re-submitted ``iterations`` times with a root taskwait between
    (``run()``: the single scope-less main program; ``run_scopes()``:
    one per tenant, each on its own client core)."""

    __slots__ = ("scope_id", "name", "specs", "iterations", "weight",
                 "epoch", "marks", "finish_us", "serial_us", "tasks")

    def __init__(self, scope_id: Optional[int], name: str,
                 specs: List[SimTaskSpec], iterations: int,
                 weight: float = 1.0) -> None:
        self.scope_id = scope_id
        self.name = name
        self.specs = specs
        self.iterations = iterations
        self.weight = weight
        self.epoch = 0
        self.marks: List[Tuple[float, int, int]] = []
        self.finish_us = 0.0
        self.serial_us = 0.0
        self.tasks = 0


class RuntimeSimulator:
    """Event-driven simulation of `TaskRuntime` on `num_cores` virtual
    cores, driving the shared dependence-policy objects.

    Core 0 runs the "main thread" program (creates the top-level tasks,
    then taskwaits, working as a normal worker while waiting) — the same
    structure as the real runtime and the paper's benchmarks. Under the
    ``dast`` policy, core ``num_cores - 1`` is the dedicated manager.
    """

    def __init__(self, num_cores: int, mode: str = "ddast",
                 params: Optional[DDASTParams] = None,
                 costs: Optional[SimCosts] = None,
                 trace: bool = False,
                 num_shards: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 placement: Any = "round_robin",
                 replay: bool = False,
                 delegation: bool = True,
                 metrics: bool = False,
                 metrics_interval_us: float = 200.0) -> None:
        # mode validation lives in the policy registry (raises on an
        # unknown mode) — the driver itself stays free of mode branching
        if mode_needs_manager_thread(mode) and num_cores < 2:
            # core P-1 is the dedicated manager; with one core the main
            # program could never run and the result would be silently
            # empty.
            raise ValueError("dast needs >= 2 cores (one is the manager)")
        if num_shards is not None and num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if batch_size is not None and batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.P = num_cores
        self.mode = mode
        self.params = params or DDASTParams()
        self.costs = costs or SimCosts()
        self.trace_enabled = trace
        self.num_shards = num_shards
        self.batch_size = batch_size
        self.placement_kind = placement
        self.replay = replay
        self.delegation = delegation
        self.metrics_enabled = metrics
        self.metrics_interval_us = metrics_interval_us

    # -- public ---------------------------------------------------------
    def run(self, specs: List[SimTaskSpec],
            iterations: int = 1) -> SimResult:
        """Simulate the graph; with ``iterations > 1`` the main program
        re-submits the same spec graph that many times with a root
        taskwait between iterations (the paper's epoch/timestep loop) —
        the shape record-and-replay (``replay=True``) exploits."""
        if iterations < 1:
            raise ValueError("iterations must be >= 1")
        charge = self._make_charge()
        tracer = self._make_tracer(charge)
        placement = self._make_placement()
        policy = self._make_policy(placement, charge, replay=self.replay,
                                   tracer=tracer)
        prog = _SimProgram(None, "main", list(specs), iterations)
        hub, sampler = self._make_metrics(charge, placement, policy)
        return self._drive([prog], charge, placement, policy, tracer,
                           hub=hub, sampler=sampler)

    def run_scopes(self, scope_specs: Sequence[List[SimTaskSpec]],
                   weights: Optional[Sequence[float]] = None,
                   max_inflight: Optional[Sequence[Optional[int]]] = None,
                   iterations: int = 1,
                   names: Optional[Sequence[str]] = None) -> SimResult:
        """Multi-tenant event loop: one virtual *client core* per entry
        of ``scope_specs`` runs that scope's program (create the graph,
        taskwait — working as a normal worker while blocked — then
        re-submit ``iterations`` times), mirroring ``TaskRuntime``
        client threads with ``open_scope``. The same scope layers run
        underneath: the region-keying shim, one replay slot per scope
        (``replay=True``), and weighted-deficit-round-robin admission
        (``weights``, per-scope ``max_inflight``). Per-scope rollups
        land in ``SimResult.scopes``."""
        S = len(scope_specs)
        if S < 1:
            raise ValueError("run_scopes needs at least one scope")
        if iterations < 1:
            raise ValueError("iterations must be >= 1")
        P = self.P
        if S > P:
            raise ValueError(f"{S} scopes need at least {S} cores")
        if mode_needs_manager_thread(self.mode) and S > P - 1:
            raise ValueError("dast reserves the last core for the "
                             "manager: need num_cores > num_scopes")
        weights = list(weights) if weights is not None else [1.0] * S
        caps = list(max_inflight) if max_inflight is not None \
            else [None] * S
        names = list(names) if names is not None \
            else [f"scope{i}" for i in range(S)]
        if not (len(weights) == len(caps) == len(names) == S):
            raise ValueError("weights/max_inflight/names length mismatch")
        charge = self._make_charge()
        tracer = self._make_tracer(charge)
        placement = FairAdmission(self._make_placement())
        # the scope multiplexer owns the replay wrapping (one recording
        # slot per scope), so the base policy stays live
        policy = ScopedPolicy(self._make_policy(placement, charge,
                                                replay=False,
                                                tracer=tracer),
                              replay=self.replay)
        programs = []
        for i in range(S):
            sid = i + 1
            policy.register_scope(sid)
            placement.register_scope(sid, weights[i], caps[i])
            programs.append(_SimProgram(sid, names[i],
                                        list(scope_specs[i]), iterations,
                                        weight=weights[i]))
        hub, sampler = self._make_metrics(charge, placement, policy)
        return self._drive(programs, charge, placement, policy, tracer,
                           hub=hub, sampler=sampler)

    def _make_charge(self) -> SimCharger:
        """Wait-free shard-lock accounting only applies where shard
        locks exist; other modes keep the blocking model regardless of
        the ``delegation`` flag."""
        return SimCharger(self.costs,
                          delegation=self.delegation
                          and mode_uses_shards(self.mode))

    def _make_tracer(self, charge: SimCharger):
        """Virtual-time tracer: stamps `charge.now` and prices each
        append through `SimCharger.trace_event()`, so the traced run's
        makespan honestly carries the instrumentation cost."""
        if not self.trace_enabled:
            return NULL_TRACER
        return TraceRecorder(self.P, clock=lambda: charge.now,
                             charge=charge, time_unit="us")

    def _make_metrics(self, charge: SimCharger, placement, policy):
        """Virtual-time metrics plane: the hub prices every instrument
        write through ``SimCharger.metric_event()`` and the sampler
        prices each pass through ``metric_sample()`` — same honesty
        contract as :meth:`_make_tracer`, so the overhead gate in
        bench_metrics.py measures a real cost."""
        if not self.metrics_enabled:
            return NULL_METRICS, None
        hub = MetricsHub(self.P, clock=lambda: charge.now,
                         charge=charge, time_unit="us")
        sampler = MetricsSampler(clock=lambda: charge.now,
                                 interval=self.metrics_interval_us,
                                 charge=charge)
        sampler.add_probe("ready", placement.ready_count)
        sampler.add_probe(
            "ready_depth",
            lambda: {str(i): len(d)
                     for i, d in enumerate(placement.deques)})
        sampler.add_probe("pending_msgs", policy.pending)
        sampler.add_probe("in_graph", policy.in_graph)
        sampler.add_probe("busy_frac", lambda: hub.busy_fraction(self.P))
        if isinstance(placement, FairAdmission):
            sampler.add_probe("admission_backlog",
                              placement.admission_backlog)
            sampler.add_probe("admission_waits",
                              placement.admission_waits_total)
            sampler.add_probe(
                "scope_inflight",
                lambda: {str(k): v
                         for k, v in placement.scope_inflight().items()})
        return hub, sampler

    def _make_placement(self):
        return make_placement(
            self.placement_kind, self.P,
            num_shards=(self.num_shards or self.P)
            if mode_uses_shards(self.mode) else None)

    def _make_policy(self, placement, charge: SimCharger, replay: bool,
                     tracer=NULL_TRACER):
        return make_policy(
            self.mode, self.P,
            num_workers=self.P,
            params=self.params,
            placement=placement,
            charge=charge,
            main_slot=0,
            num_shards=self.num_shards or self.P,
            batch_size=self.batch_size,
            delegation=self.delegation,
            replay=replay,
            tracer=tracer)

    # -- the event loop (shared by run and run_scopes) ------------------
    def _drive(self, programs: List["_SimProgram"], charge: SimCharger,
               placement, policy, tracer=NULL_TRACER,
               hub=NULL_METRICS, sampler=None) -> SimResult:
        P, costs = self.P, self.costs
        mgr_core = P - 1 if policy.needs_manager_thread else -1

        roots: Dict[int, WorkDescriptor] = {}
        for core, prog in enumerate(programs):
            root = WorkDescriptor(func=None, label=f"sim-{prog.name}",
                                  scope=prog.scope_id)
            root.state = TaskState.RUNNING
            roots[core] = root

        serial_us = 0.0
        total_tasks = 0
        for prog in programs:
            stack_count = [list(prog.specs)]
            while stack_count:
                for s in stack_count.pop():
                    prog.serial_us += s.dur
                    prog.tasks += 1
                    if s.children:
                        stack_count.append(s.children)
            prog.serial_us *= prog.iterations
            prog.tasks *= prog.iterations
            serial_us += prog.serial_us
            total_tasks += prog.tasks

        trace: List[Tuple[float, int, int]] = []
        exec_order: List[str] = []

        # events: (time, seq, core, kind, wd). Kinds: "step" re-evaluates
        # the core's state machine; "fin" delivers a task-body completion
        # at its finish time (evaluating it eagerly at start time would
        # advance virtual locks into the future and stall every
        # earlier-timestamped acquirer — a causality violation).
        events: List[Tuple[float, int, int, str, Optional[WorkDescriptor]]] = []
        seq = [0]
        sleeping: set = set()
        finished = [False]
        makespan = [0.0]

        def schedule(t: float, core: int, kind: str = "step",
                     wd: Optional[WorkDescriptor] = None) -> None:
            heapq.heappush(events, (t, seq[0], core, kind, wd))
            seq[0] += 1

        def wake_all(t: float) -> None:
            for core in sorted(sleeping):
                schedule(t, core)
            sleeping.clear()

        def sample(t: float) -> None:
            if self.trace_enabled:
                trace.append((t, policy.in_graph(),
                              placement.ready_count()))

        # progs[core] = stack of creation frames [specs, idx, parent_wd];
        # parent_wd is None for a top-level (program-root) frame. Program
        # p runs on client core p (run(): the single program on core 0).
        progs: Dict[int, List[List[Any]]] = {i: [] for i in range(P)}
        for core, prog in enumerate(programs):
            progs[core].append([list(prog.specs), 0, None])

        # iteration (epoch) bookkeeping: cumulative snapshots taken at
        # each program-root quiescence, turned into per-iteration deltas
        # below (per program — each tenant has its own epoch loop)
        done = [0]

        def finish_epoch(core: int) -> None:
            prog = programs[core]
            t = max(makespan[0], charge.now)
            policy.notify_quiescent(True, scope_id=prog.scope_id)
            if tracer.enabled:
                # quiesce markers delimit replay windows for the
                # detectors: replayed iterations are manager-silent by
                # design, not starving (see trace/detect.py)
                tracer.quiesce({"scope": prog.scope_id,
                                "replay_iterations": replay_iterations_of(
                                    policy, prog.scope_id)})
            prog.marks.append((t, charge.lock_acquisitions(),
                               policy.stats()["messages_processed"]))
            if sampler is not None:
                # quiescence edge: always sample (the same boundary the
                # threaded sampler's quiescent_callback rides)
                sampler.tick(force=True)
            prog.epoch += 1
            if prog.epoch < prog.iterations:
                progs[core].append([list(prog.specs), 0, None])
                schedule(charge.now, core)
                return
            prog.finish_us = t
            done[0] += 1
            if done[0] == len(programs):
                finished[0] = True
                makespan[0] = t
            else:
                # this client core keeps working for the other tenants
                schedule(charge.now, core)

        def run_worker(core: int) -> bool:
            """Pop + start one ready task on `core` at charge.now.
            Returns True if a task was started."""
            wd = placement.pop(core)
            if wd is None:
                return False
            t = charge.now
            dur = wd.duration * (costs.pollution
                                 if core in charge.polluted else 1.0)
            charge.polluted.discard(core)
            wd.mark_running()
            if hub.enabled:
                hub.task_start(core)
            if tracer.enabled:
                tracer.task_event(EV_START, wd, core)
            exec_order.append(wd.label)
            children = getattr(wd, "sim_children", None)
            if children:
                # parent body runs for `dur`, then the creation frame
                # takes over (children created after the body, as in the
                # threaded apps where the body IS the creation loop).
                progs[core].append([children, 0, wd])
                schedule(t + dur, core)
            else:
                schedule(t + dur, core, kind="fin", wd=wd)
            return True

        def step_core(core: int, t: float) -> None:
            charge.begin(core, t)
            if core == mgr_core:            # dedicated manager [7]
                n = policy.drain_all()
                if n:
                    sample(charge.now)
                    wake_all(charge.now)
                    schedule(charge.now, core)
                else:
                    sleeping.add(core)
                return
            stack = progs[core]
            if stack:
                frame = stack[-1]
                specs_, idx, parent = frame
                if idx < len(specs_):       # creation program
                    spec = specs_[idx]
                    frame[1] += 1
                    charge.create()
                    parent_wd = parent if parent is not None \
                        else roots[core]
                    # the scopes keying shim: a tenant's regions are
                    # scope-qualified exactly as on the real runtime
                    wd = WorkDescriptor(
                        func=None,
                        deps=tuple(scoped_deps(parent_wd.scope,
                                               spec.deps)),
                        label=spec.label, parent=parent_wd)
                    wd.duration = spec.dur
                    wd.sim_children = spec.children
                    if tracer.enabled:
                        tracer.task_event(EV_CREATED, wd, core)
                    policy.submit(wd, core)
                    sample(charge.now)
                    wake_all(charge.now)
                    schedule(charge.now, core)
                    return
                # taskwait phase of this frame
                policy.flush(core)
                waiter = parent if parent is not None else roots[core]
                # scoped waiters gate on their own subtree only (see
                # TaskRuntime._taskwait_on): children are counted from
                # creation, so children == 0 implies none of the
                # scope's submits are still queued anywhere
                if waiter.num_children_alive == 0 and \
                        (waiter.scope is not None or not policy.pending()):
                    stack.pop()
                    if parent is not None:  # nested parent completes
                        policy.notify_quiescent(False)
                        parent.mark_finished()
                        if hub.enabled:
                            hub.task_end(core, parent.duration)
                        if tracer.enabled:
                            tracer.task_event(EV_END, parent, core)
                        placement.note_executed(parent, core)
                        policy.complete(parent, core)
                        sample(charge.now)
                        wake_all(charge.now)
                        schedule(charge.now, core)
                    else:                   # main program done (epoch)
                        finish_epoch(core)
                    return
                # blocked in taskwait: fall through and work
            if run_worker(core):
                return
            # idle: offer cycles to the policy (Listing 2), take a
            # metrics sample (the DDAST idle-thread discipline), or sleep
            n = policy.idle_callback(core) \
                if policy.uses_idle_managers else 0
            if sampler is not None and sampler.tick():
                n += 1
            if n or charge.now > t:
                sample(charge.now)
                wake_all(charge.now)
                schedule(charge.now, core)
            else:
                sleeping.add(core)

        for i in range(P):
            schedule(0.0, i)

        guard = 0
        while events and not finished[0]:
            t, _, core, kind, wd = heapq.heappop(events)
            makespan[0] = max(makespan[0], t)
            if kind == "fin":
                charge.begin(core, t)
                wd.mark_finished()
                if hub.enabled:
                    hub.task_end(core, wd.duration)
                if tracer.enabled:
                    tracer.task_event(EV_END, wd, core)
                placement.note_executed(wd, core)
                policy.complete(wd, core)
                sample(charge.now)
                wake_all(charge.now)
                schedule(charge.now, core)
            else:
                step_core(core, t)
            guard += 1
            if guard > 100_000_000:  # pragma: no cover
                raise RuntimeError("simulator exceeded event budget")

        st = policy.stats()

        def _deltas(marks):
            mk, la, msg = [], [], []
            prev = (0.0, 0, 0)
            for mark in marks:
                mk.append(mark[0] - prev[0])
                la.append(mark[1] - prev[1])
                msg.append(mark[2] - prev[2])
                prev = mark
            return mk, la, msg

        # the flat iter_* lists keep their single-program meaning; with
        # several tenants the boundaries interleave, so per-scope lists
        # live in the rollups instead
        iter_mk, iter_la, iter_msg = _deltas(
            programs[0].marks if len(programs) == 1 else [])
        scopes: Dict[str, dict] = {}
        if len(programs) > 1 or programs[0].scope_id is not None:
            for prog in programs:
                mk, _, _ = _deltas(prog.marks)
                # lock/message counters are runtime-wide, so deltas at
                # one scope's boundaries would silently include every
                # OTHER tenant's activity — per-scope rollups carry only
                # quantities attributable to the scope (verify replay
                # cost globally via iterations=1 vs iterations=n runs)
                entry = {"tasks": prog.tasks, "weight": prog.weight,
                         "finish_us": prog.finish_us,
                         "iter_makespans_us": mk}
                entry.update(scope_rollup(placement, policy,
                                          prog.scope_id))
                scopes[prog.name] = entry
        metrics_snap: Dict[str, object] = {}
        if hub.enabled:
            metrics_snap = dict(hub.snapshot())
            metrics_snap["gauges"] = {
                "ready": placement.ready_count(),
                "pending_msgs": policy.pending(),
                "in_graph": policy.in_graph(),
            }
            if sampler is not None:
                metrics_snap["sampler"] = sampler.snapshot()
        return SimResult(
            makespan_us=max(makespan[0], charge.max_free_at()),
            serial_us=serial_us,
            tasks=total_tasks,
            lock_wait_us=charge.lock_wait_us(),
            lock_acquisitions=charge.lock_acquisitions(),
            messages=st["messages_processed"],
            max_in_graph=st["max_in_graph"],
            total_edges=st["total_edges"],
            delegated_portions=st["delegated_portions"],
            combined_drains=st["combined_drains"],
            lock_handoffs=list(st["shard_lock_handoffs"]),
            trace=trace,
            events=tracer.events() if tracer.enabled else [],
            trace_dropped=tracer.dropped,
            worker_steals=[d.stolen for d in placement.deques],
            load_cap_skips=int(placement.stats().get("load_cap_skips", 0)),
            exec_order=exec_order,
            iterations=max(p.iterations for p in programs),
            iter_makespans_us=iter_mk,
            iter_lock_acq=iter_la,
            iter_messages=iter_msg,
            scopes=scopes,
            metrics=metrics_snap,
        )
