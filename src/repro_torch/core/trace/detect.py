"""Copy of `repro/core/trace/detect.py`.

Detrimental-pattern detectors over merged event timelines.

The three pathologies of "Detrimental task execution patterns in
mainstream OpenMP runtimes" (PAPERS.md, 2406.03077), phrased against
this runtime's structures:

  * **ready-queue starvation** — a worker sits idle while ready work
    exists: another slot's deque is deep (placement imbalance the
    steal path isn't covering), or the manager queues hold a backlog
    nobody is draining (every thread is busy or the admission gate is
    too tight).
  * **priority inversion** — under the critical-path replay placement
    a low-band task *started* while a strictly higher-band task had
    been ready (globally available) since earlier.  Cross-checked
    against the bands ``CriticalPathPlacement`` publishes: ``ready``
    events carry ``("band", b)`` payloads, so the detector only speaks
    where band data exists.
  * **affinity miss** — a task the shard-affine placement deliberately
    pinned (``ready`` payload ``"affine"``) executed on a different
    slot, correlated with a ``steal`` event for the same task (a miss
    without a steal is a benign re-pop; a steal of an affine task
    means locality was traded for load balance).

Replay awareness (the false-positive fix the replay subsystem needs):
replayed iterations skip dependence analysis and manager messages *by
design*, so windows whose closing ``quiesce`` boundary shows
``replay_iterations`` advanced are treated as manager-silent — the
backlog-based starvation signal is suppressed there; depth-based
signals (which read only ``ready``/``start`` events, present under
replay too) remain active.

All detectors return :class:`Finding` records and are pure functions of
the event list — fabricated timelines make positive oracles, clean
sim runs make negative ones.

One timeline quirk the sweeps must absorb: the simulator's documented
causality approximation (state produced by a core running locally ahead
becomes visible to other cores at their *next* event) can stamp a
task's ``start`` with an earlier virtual time than its ``ready``.
Each detector therefore pairs ready/start by ``wd_id`` in whichever
order they arrive, never assuming ready sorts first.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .recorder import (EV_COMBINE, EV_DELEGATE, EV_END, EV_MSG_DRAIN,
                       EV_MSG_ENQ, EV_QUIESCE, EV_READY, EV_START,
                       EV_STEAL, TraceEvent)

STARVATION = "ready_queue_starvation"
INVERSION = "priority_inversion"
AFFINITY_MISS = "affinity_miss"


@dataclass
class Finding:
    kind: str
    t0: float
    t1: float
    slot: int = -1                # the slot the finding points at
    count: int = 0                # occurrences / tasks involved
    detail: dict = field(default_factory=dict)


# ---------------------------------------------------------------------
# replay-window bookkeeping
def replay_windows(events: Sequence[TraceEvent]
                   ) -> List[Tuple[float, float]]:
    """Time intervals served by record-and-replay: for each scope, the
    span between consecutive ``quiesce`` boundaries whose
    ``replay_iterations`` payload advanced. Manager events are absent
    there by design, so backlog-based signals must stay silent."""
    wins: List[Tuple[float, float]] = []
    last: Dict[Optional[int], Tuple[float, int]] = {}
    for e in events:
        if e.ev != EV_QUIESCE:
            continue
        data = e.data or {}
        scope = data.get("scope") if isinstance(data, dict) else None
        iters = data.get("replay_iterations", 0) \
            if isinstance(data, dict) else 0
        t_prev, iters_prev = last.get(scope, (0.0, 0))
        if iters > iters_prev:
            wins.append((t_prev, e.t))
        last[scope] = (e.t, iters)
    wins.sort()
    return wins


def _in_windows(t: float, wins: Sequence[Tuple[float, float]]) -> bool:
    return any(a <= t <= b for a, b in wins)


def _msg_count(data) -> int:
    """Message events carry ``(kind, where, n)`` payloads; ``n`` is the
    task count the entry covers (batches > 1)."""
    if isinstance(data, (tuple, list)) and len(data) >= 3:
        return int(data[2])
    return 1


# ---------------------------------------------------------------------
def detect_starvation(events: Sequence[TraceEvent],
                      min_dur: Optional[float] = None,
                      depth_min: int = 4,
                      backlog_min: int = 8) -> List[Finding]:
    """Sweep the timeline tracking (a) per-slot ready-deque depth from
    ``ready``/``start`` events, (b) worker busy/idle state from
    ``start``/``end``, (c) manager backlog from enq/drain counts. Flag
    sustained spans where a known worker is idle while either another
    slot's deque holds ``depth_min``+ tasks (the steal path is not
    covering the imbalance) or the managers sit on ``backlog_min``+
    undrained tasks with nothing ready anywhere. Spans shorter than
    ``min_dur`` (default 2 % of the traced span) are noise — a ready
    burst always precedes the pops that serve it. A ``msg_drained``
    event is *progress*, so it closes any backlog-only span: deep
    mailboxes behind an actively draining manager are ordinary
    pipelining, and only a drain gap longer than ``min_dur`` with idle
    workers waiting on it counts as starvation."""
    if not events:
        return []
    t_lo, t_hi = events[0].t, events[-1].t
    if min_dur is None:
        min_dur = 0.02 * max(t_hi - t_lo, 1e-12)
    wins = replay_windows(events)

    #: per-slot deque depth; banded ready events (critical-path replay
    #: lane, payload ``("band", b)``) go to the SHARED key instead — the
    #: priority lane is one pool every worker pops, so its depth is not
    #: placement imbalance and a start from it is progress (closes a
    #: backlog-style span), exactly like a manager drain
    SHARED = -2
    depth: Dict[int, int] = {}          # slot -> ready-deque depth
    placed: Dict[int, int] = {}         # wd_id -> slot it was pushed to
    early: set = set()                  # started before its ready event
    busy: Dict[int, bool] = {}          # slot -> executing now (workers
    #                                     appear at their first start)
    backlog = 0                         # undrained manager entries

    findings: List[Finding] = []
    span_start: Optional[float] = None
    span_deep_slot = -1
    span_backlog_only = True
    span_idle: List[int] = []           # idle set when the span opened
    t_prev = t_lo          # when the state creating a new span arose

    def close_span(t: float) -> None:
        nonlocal span_start
        if span_start is not None and t - span_start >= min_dur:
            findings.append(Finding(
                STARVATION, span_start, t, slot=span_deep_slot,
                count=len(span_idle),
                detail={"idle_slots": sorted(span_idle),
                        "backlog_only": span_backlog_only}))
        span_start = None

    for e in events:
        t = e.t
        # -- evaluate the condition over the interval ending at `t` ----
        idle_workers = [s for s, b in busy.items() if not b]
        deep_elsewhere = max(
            ((d, s) for s, d in depth.items()
             if s != SHARED and d >= depth_min
             and any(w != s for w in idle_workers)),
            default=None)
        total_depth = sum(depth.values())
        starving_on_backlog = (idle_workers and backlog >= backlog_min
                               and total_depth == 0
                               and not _in_windows(t, wins))
        flag = bool(deep_elsewhere) or starving_on_backlog
        if flag and span_start is None:
            # the condition became true when the *previous* event was
            # applied; a sparse timeline (enq ... long gap ... drain)
            # must accrue that whole gap, not open at the closing event
            span_start = t_prev
            span_deep_slot = deep_elsewhere[1] if deep_elsewhere else -1
            span_backlog_only = not deep_elsewhere
            span_idle = idle_workers
        elif not flag and span_start is not None:
            close_span(t)
        # -- apply the event ------------------------------------------
        if e.ev == EV_READY:
            banded = (isinstance(e.data, (tuple, list))
                      and len(e.data) == 2 and e.data[0] == "band")
            if e.wd_id in early:        # start already swept past
                early.discard(e.wd_id)
            else:
                dst = SHARED if banded else e.slot
                depth[dst] = depth.get(dst, 0) + 1
                placed[e.wd_id] = dst
        elif e.ev == EV_START:
            src = placed.pop(e.wd_id, None)
            if src is not None:
                depth[src] = depth.get(src, 0) - 1
                if src == SHARED and span_start is not None \
                        and span_backlog_only:
                    close_span(t)       # shared-lane pop = progress
            else:                       # ready not swept yet: cancel it
                early.add(e.wd_id)
            busy[e.slot] = True
        elif e.ev == EV_END:
            busy[e.slot] = False
        elif e.ev in (EV_MSG_ENQ, EV_DELEGATE):
            # a delegated portion is backlog exactly like a mailbox
            # entry: published, not yet applied by a combiner
            backlog += _msg_count(e.data)
        elif e.ev == EV_MSG_DRAIN:
            backlog -= _msg_count(e.data)
            if span_start is not None and span_backlog_only:
                close_span(t)           # the manager IS making progress
        elif e.ev == EV_COMBINE:
            # a combine session applied n published portions in one
            # critical section; the per-portion arithmetic already rode
            # the msg_drained events — this is pure progress evidence
            if span_start is not None and span_backlog_only:
                close_span(t)
        t_prev = t
    close_span(t_hi)
    return findings


# ---------------------------------------------------------------------
def detect_priority_inversion(events: Sequence[TraceEvent],
                              min_band_gap: int = 1,
                              min_count: int = 3) -> List[Finding]:
    """Only meaningful where ``ready`` events carry published bands
    (``CriticalPathPlacement`` under an active replay recording): flag
    each ``start`` of band *b* while a task of band >= *b* +
    ``min_band_gap`` had been ready strictly earlier and was still
    unstarted. Fewer than ``min_count`` occurrences is scheduling
    jitter (a band swap racing one pop), not a pathology."""
    avail: Dict[int, Tuple[int, float]] = {}   # wd_id -> (band, t_ready)
    started: set = set()                # starts swept before their ready
    hits: List[Tuple[float, int, int]] = []
    for e in events:
        if e.ev == EV_READY:
            d = e.data
            if isinstance(d, (tuple, list)) and len(d) == 2 \
                    and d[0] == "band" and e.wd_id not in started:
                avail[e.wd_id] = (int(d[1]), e.t)
        elif e.ev == EV_START:
            mine = avail.pop(e.wd_id, None)
            if mine is None:
                started.add(e.wd_id)
                continue
            band, _ = mine
            best = -1
            for b2, t2 in avail.values():
                if t2 < e.t and b2 > best:
                    best = b2
            if best >= band + min_band_gap:
                hits.append((e.t, band, best))
    if len(hits) < min_count:
        return []
    return [Finding(INVERSION, hits[0][0], hits[-1][0], count=len(hits),
                    detail={"examples": hits[:8]})]


# ---------------------------------------------------------------------
def detect_affinity_misses(events: Sequence[TraceEvent],
                           min_count: int = 3,
                           min_frac: float = 0.25) -> List[Finding]:
    """Among tasks the placement pinned for locality (``ready`` payload
    ``"affine"``), count those that *started* on a different slot AND
    have a ``steal`` event — locality was built, then traded away.
    Flagged only when both the absolute count and the affine fraction
    clear their thresholds: sporadic steals are the load balancer
    working as intended."""
    placed: Dict[int, Tuple[int, bool]] = {}   # wd_id -> (slot, affine)
    stolen: Dict[int, int] = {}                # wd_id -> victim slot
    started_at: Dict[int, Tuple[float, int]] = {}  # start before ready
    affine_total = 0
    misses: List[Tuple[float, int, int]] = []
    for e in events:
        if e.ev == EV_READY:
            affine = e.data == "affine"
            if affine:
                affine_total += 1
            s = started_at.pop(e.wd_id, None)
            if s is not None:           # pair late: the start came first
                if affine and s[1] != e.slot and e.wd_id in stolen:
                    misses.append((s[0], e.slot, s[1]))
            else:
                placed[e.wd_id] = (e.slot, affine)
        elif e.ev == EV_STEAL:
            stolen[e.wd_id] = e.data if isinstance(e.data, int) else -1
        elif e.ev == EV_START:
            p = placed.pop(e.wd_id, None)
            if p is None:
                started_at[e.wd_id] = (e.t, e.slot)
            elif p[1] and e.slot != p[0] and e.wd_id in stolen:
                misses.append((e.t, p[0], e.slot))
    if not affine_total or len(misses) < min_count:
        return []
    frac = len(misses) / affine_total
    if frac < min_frac:
        return []
    return [Finding(AFFINITY_MISS, misses[0][0], misses[-1][0],
                    count=len(misses),
                    detail={"affine_total": affine_total,
                            "miss_frac": round(frac, 4),
                            "examples": misses[:8]})]


# ---------------------------------------------------------------------
def detect_all(events: Sequence[TraceEvent], **kw) -> List[Finding]:
    """Run every detector; keyword args prefixed ``starvation_`` /
    ``inversion_`` / ``affinity_`` are routed to the matching one."""
    def sub(prefix):
        n = len(prefix)
        return {k[n:]: v for k, v in kw.items() if k.startswith(prefix)}
    out = detect_starvation(events, **sub("starvation_"))
    out += detect_priority_inversion(events, **sub("inversion_"))
    out += detect_affinity_misses(events, **sub("affinity_"))
    return out


# ---------------------------------------------------------------------
class IncrementalDetector:
    """Stateful wrapper driving the batch detectors over a *live*
    window mid-run (the metrics sampler calls :meth:`sweep` each tick)
    instead of once over the final timeline.

    Each sweep runs ``detect_all`` on the trailing ``window`` events
    and reports only findings not yet seen — dedup keys on
    ``(kind, t0, slot)``, which is stable because every detector stamps
    ``t0`` from event times, not wall clock.  When the full timeline
    fits inside the window, the union of sweep results equals a single
    post-hoc ``detect_all`` pass (the agreement property
    ``bench_metrics`` gates in CI); a longer run degrades gracefully to
    phase-local findings, which is exactly what the live consumer
    (``DynamicTuner``) wants.
    """

    def __init__(self, window: int = 4096, **kw) -> None:
        self.window = window
        self.kw = kw
        self._seen: set = set()
        self.findings: List[Finding] = []

    def sweep(self, events: Sequence[TraceEvent]) -> List[Finding]:
        """Detect over the trailing window; return only NEW findings."""
        evs = events[-self.window:] if len(events) > self.window else events
        fresh: List[Finding] = []
        for f in detect_all(evs, **self.kw):
            key = (f.kind, round(f.t0, 9), f.slot)
            if key not in self._seen:
                self._seen.add(key)
                fresh.append(f)
                self.findings.append(f)
        return fresh
