"""Copy of `repro/core/autotune.py`.

Dynamic DDAST parameter tuning — the paper's stated future work (§8:
"the runtime manager will dynamically tune its parameters to fit the
application requirements").

A feedback controller registered as a (low-priority) Functionality
Dispatcher callback: idle threads occasionally sample runtime pressure
and adjust the DDASTParams in place:

  * queue backlog grows & ready pool starving -> more manager threads
    (up to num_threads/2) and bigger MAX_OPS_THREAD drains;
  * queues near-empty -> decay managers toward the tuned static default
    (num_threads/8) to recover locality (paper §5.1's finding).

Since the unified policy engine, the tuner also hill-climbs the sharded
policy's ``num_shards`` online: at taskwait quiescence (the dispatcher's
``notify_quiescent`` hook — the only moment ``ShardedPolicy.resize`` is
legal) it reads the single ``ShardedPolicy.stats()`` dict, computes the
lock-wait cost per processed message since the previous adjustment, and
doubles/halves the shard count in the improving direction. Two
consecutive direction flips mean the optimum is bracketed and the
controller settles — the same bounded-hysteresis discipline as the
manager-thread loop, so it cannot oscillate.

With tracing on (``trace=True``), the tuner additionally closes the
observability loop: a quiescence hook runs the detrimental-pattern
detectors (``core.trace.detect``) over the events recorded since the
last boundary and folds their verdicts into the control decisions —
persistent ready-queue starvation votes for a wider manager pool and
un-settles the shard hill-climb so it re-brackets under the observed
load. Detection runs only at quiescence (never on the task hot path)
and only over the event delta, so its cost scales with traffic, not
with run length.

All adjustments are bounded and hysteretic; the tuned static defaults
remain the fixed point under calm load.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Tuple

if TYPE_CHECKING:  # pragma: no cover
    from .runtime import TaskRuntime


@dataclass
class TunerConfig:
    interval_s: float = 0.002       # min time between adjustments
    backlog_high: int = 32          # pending msgs per worker: pressure
    backlog_low: int = 2
    ops_step: int = 4
    max_ops: int = 64
    # -- num_shards hill-climb (sharded policy only) --------------------
    tune_shards: bool = True
    shard_min_messages: int = 64    # min msgs between shard adjustments
    shard_improve_eps: float = 0.05  # relative improvement to keep going
    shard_cap: Optional[int] = None  # default: max(64, 4 * num_workers)
    # -- trace-detector feedback (runtimes built with trace=True) -------
    trace_feedback: bool = True
    trace_starve_votes: int = 2     # starvation verdicts before acting


class DynamicTuner:
    def __init__(self, runtime: "TaskRuntime",
                 cfg: TunerConfig = TunerConfig()) -> None:
        self.rt = runtime
        self.cfg = cfg
        self._last = 0.0
        self._lock = threading.Lock()
        self.adjustments: List[Tuple[float, int, int]] = []
        p = runtime.params
        self._static_mgr = p.resolved_max_threads(runtime.num_workers)
        # ensure an explicit, mutable starting point
        if p.max_ddast_threads is None:
            p.max_ddast_threads = self._static_mgr
        runtime.dispatcher.register("ddast-autotune", self.callback,
                                    priority=0)
        # -- shard-count controller state -------------------------------
        self.shard_adjustments: List[Tuple[float, int]] = []
        self._shard_dir = 1            # +1: double, -1: halve
        self._shard_flips = 0
        self._shard_settled = False
        self._shard_prev_metric: Optional[float] = None
        self._m0 = 0                   # messages at last adjustment
        self._w0 = 0.0                 # lock wait at last adjustment
        self._h0 = 0                   # lock handoffs at last adjustment
        if cfg.tune_shards and hasattr(runtime.policy, "resize"):
            runtime.dispatcher.register_quiescent(
                "shard-autotune", self.quiescent_callback, priority=0)
        # -- trace-detector feedback state ------------------------------
        self.trace_verdicts: List = []   # every Finding the hook saw
        self.trace_actions: List[Tuple[float, str]] = []
        self._starve_votes = 0
        self._trace_seen = 0             # total_appended at last sweep
        if cfg.trace_feedback and getattr(runtime.tracer, "enabled",
                                          False):
            sampler = getattr(runtime, "sampler", None)
            if sampler is not None and \
                    getattr(sampler, "detector", None) is not None:
                # live metrics plane present: the sampler's incremental
                # detector sweeps the trailing trace window every tick,
                # so verdicts arrive MID-PHASE (already deduplicated)
                # instead of only at quiescence — the quiescence hook
                # would re-detect the same findings, so it stays off
                sampler.on_findings = self.note_trace_verdicts
            else:
                runtime.dispatcher.register_quiescent(
                    "trace-feedback", self.trace_callback, priority=1)

    # -- dispatcher callback --------------------------------------------
    def callback(self, worker_id: int) -> None:
        del worker_id
        now = time.perf_counter()
        with self._lock:
            if now - self._last < self.cfg.interval_s:
                return
            self._last = now
        rt, p, c = self.rt, self.rt.params, self.cfg
        n = rt.num_workers
        backlog = rt._pending_msgs() / max(n, 1)
        ready = rt.ready_count()
        mgr_cap = max(1, n // 2)
        if backlog > c.backlog_high and ready < p.min_ready_tasks:
            # pressure: the managers cannot keep up — widen the manager
            # pool and deepen per-queue drains
            p.max_ddast_threads = min(mgr_cap, p.max_ddast_threads + 1)
            p.max_ops_thread = min(c.max_ops, p.max_ops_thread + c.ops_step)
            self.adjustments.append((now, p.max_ddast_threads,
                                     p.max_ops_thread))
        elif backlog < c.backlog_low and \
                p.max_ddast_threads > self._static_mgr:
            # calm: shrink back toward the locality-friendly default
            p.max_ddast_threads -= 1
            p.max_ops_thread = max(8, p.max_ops_thread - c.ops_step)
            self.adjustments.append((now, p.max_ddast_threads,
                                     p.max_ops_thread))

    # -- quiescence callback: num_shards hill-climb ---------------------
    def quiescent_callback(self, worker_id: int) -> None:
        del worker_id
        pol = self.rt.policy
        if self._shard_settled or not hasattr(pol, "resize"):
            return
        # Nested taskwaits also notify, but their parent is still in the
        # graph — resize would refuse; don't consume a metric sample.
        if pol.pending() or pol.in_graph():
            return
        # Never resize under a live record-and-replay recording: the
        # recording freezes against the structures that exist when it
        # completes, and a mid-recording partition swap would also skew
        # the metric sample. (A *frozen* replay is unaffected — its
        # steady state never touches the shards — so tuning proceeds.)
        if getattr(pol, "recording_live", False):
            return
        self.consider_shard_step(pol.stats())

    def consider_shard_step(self, stats: dict) -> bool:
        """One hill-climb decision from a ``ShardedPolicy.stats()``
        snapshot. Split out from the dispatcher hook so the decision
        logic is testable with fabricated counter deltas. Returns True
        if a resize was applied."""
        pol, c = self.rt.policy, self.cfg
        if self._shard_settled:
            return False
        msgs = int(stats["messages_processed"])
        wait = float(stats["lock_wait_s"])
        handoffs = sum(stats.get("shard_lock_handoffs", []) or [0])
        dm = msgs - self._m0
        if dm < c.shard_min_messages:
            return False                 # not enough new signal yet
        if getattr(pol, "delegation", False):
            # Wait-free hot path: lock waits are ~0 by construction, so
            # the contention signal is combiner HANDOFFS per message —
            # each handoff is a post-release re-acquisition forced by
            # requests published behind the combiner's back, i.e. the
            # delegation-era analogue of a blocked acquire. All three
            # counters are cumulative across resize (the policy's
            # _carried merge), so the deltas stay monotone.
            metric = (handoffs - self._h0) / dm
        else:
            metric = (wait - self._w0) / dm  # lock-wait cost per message
        self._m0, self._w0, self._h0 = msgs, wait, handoffs
        prev = self._shard_prev_metric
        self._shard_prev_metric = metric
        bracketed = False
        if prev is not None and metric > prev * (1.0 - c.shard_improve_eps):
            # Stopped improving: reverse. Flips accumulate across the
            # whole climb (an improving leg does NOT reset them —
            # otherwise a clean unimodal metric bounces S/2 -> S -> 2S
            # forever). The second flip means the optimum is bracketed:
            # take one final step back toward it, then settle.
            self._shard_dir = -self._shard_dir
            self._shard_flips += 1
            bracketed = self._shard_flips >= 2
        cap = c.shard_cap or max(64, 4 * self.rt.num_workers)
        target = (pol.num_shards * 2 if self._shard_dir > 0
                  else pol.num_shards // 2)
        target = max(1, min(target, cap))
        if target == pol.num_shards:
            # nowhere to step (boundary); if bracketed we are done here
            self._shard_settled = bracketed or self._shard_settled
            return False
        if not pol.resize(target):
            # refused (work in flight): retry at the next quiescence
            # rather than latching settled at the worse bracket end
            return False
        self._shard_settled = bracketed or self._shard_settled
        self.shard_adjustments.append((time.perf_counter(), target))
        return True

    @property
    def shards_settled(self) -> bool:
        return self._shard_settled

    # -- trace-detector feedback ----------------------------------------
    def trace_callback(self, worker_id: int) -> None:
        """Quiescence hook: sweep the detectors over the trace and fold
        the verdicts in. Skipped when nothing new was recorded since
        the last boundary (replayed iterations append only lifecycle +
        quiesce events, so the probe stays cheap there too)."""
        del worker_id
        tracer = self.rt.tracer
        appended = tracer.total_appended
        if appended <= self._trace_seen:
            return
        self._trace_seen = appended
        # deferred import: autotune must stay importable without trace
        from .trace import detect_all
        self.note_trace_verdicts(detect_all(tracer.events()))

    def note_trace_verdicts(self, findings) -> bool:
        """Fold detector verdicts into the control loops (split out so
        tests can feed fabricated findings). Persistent ready-queue
        starvation — ``cfg.trace_starve_votes`` sweeps that each saw at
        least one starvation span — votes to widen the manager pool and
        to un-settle the shard hill-climb so it re-brackets under the
        load the detectors actually observed. Inversion/affinity
        verdicts are recorded for reporting but drive no knob: the
        former is a placement-band artifact, the latter is the load
        balancer's deliberate trade. Returns True if a knob moved."""
        from .trace import STARVATION
        self.trace_verdicts.extend(findings)
        if not any(f.kind == STARVATION for f in findings):
            return False
        self._starve_votes += 1
        if self._starve_votes < self.cfg.trace_starve_votes:
            return False
        self._starve_votes = 0
        now = time.perf_counter()
        p = self.rt.params
        mgr_cap = max(1, self.rt.num_workers // 2)
        acted = False
        if p.max_ddast_threads < mgr_cap:
            p.max_ddast_threads += 1
            self.adjustments.append((now, p.max_ddast_threads,
                                     p.max_ops_thread))
            self.trace_actions.append((now, "widen_managers"))
            acted = True
        if self._shard_settled:
            self._shard_settled = False
            self._shard_flips = 0
            self._shard_prev_metric = None
            self.trace_actions.append((now, "unsettle_shards"))
            acted = True
        return acted
