"""Copy of `repro/core/metrics/sampler.py`.

Time-series sampler: periodic snapshots of derived runtime signals
into bounded rings, riding the FunctionalityDispatcher.

The sampler owns no thread. It registers an idle callback and a
quiescent callback on the dispatcher, so — per the paper's DDAST
discipline — whichever worker is already idle takes the sample; on the
process backend the reaper loop ticks it between ring polls. ``tick``
is rate-limited by a wall/virtual-clock interval checked *before* a
non-blocking try-lock, so concurrent idle workers never serialize
behind a sample in progress: losers return immediately (the lock is a
mutual-exclusion guard on the read-side aggregation only — no task
hot-path ever touches it).

Probes are plain callables registered at runtime construction; each
returns a scalar (one series) or a ``{sub_name: scalar}`` dict (one
series per key — used for per-slot ready depth and per-scope
inflight). Series are bounded ``deque(maxlen=window)`` rings of
``(t, value)`` pairs.

The sampler optionally carries an :class:`IncrementalDetector`
(``core.trace.detect``): every sample with fresh trace events sweeps
the detectors over the live window and forwards *new* findings to the
``on_findings`` hook — this is how ``DynamicTuner`` gets starvation /
inversion verdicts mid-phase instead of only at quiescence.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["MetricsSampler"]


class MetricsSampler:
    def __init__(self, clock: Callable[[], float], interval: float,
                 window: int = 512, charge=None, tracer=None,
                 detector=None,
                 on_findings: Optional[Callable[[list], object]] = None
                 ) -> None:
        self.clock = clock
        self.interval = interval
        self.window = window
        self._charge = charge
        self.tracer = tracer
        self.detector = detector
        self.on_findings = on_findings
        self._probes: List[Tuple[str, Callable[[], object]]] = []
        self.series: Dict[str, deque] = {}
        self.samples = 0
        self._last: Optional[float] = None
        self._tick_lock = threading.Lock()
        self._trace_seen = 0
        self.live_findings: list = []

    def add_probe(self, name: str, fn: Callable[[], object]) -> None:
        self._probes.append((name, fn))

    # -- dispatcher hooks ----------------------------------------------
    def callback(self, worker_id: int) -> int:
        """Idle-worker hook: at most one sample per interval."""
        del worker_id
        return 1 if self.tick() else 0

    def quiescent_callback(self, worker_id: int) -> int:
        """Quiescence hook: always sample — phase boundaries are the
        points the post-hoc pipeline already anchors on."""
        del worker_id
        return 1 if self.tick(force=True) else 0

    # -- sampling -------------------------------------------------------
    def tick(self, force: bool = False) -> bool:
        t = self.clock()
        last = self._last
        if not force and last is not None and t - last < self.interval:
            return False
        if not self._tick_lock.acquire(False):
            return False                 # someone else is sampling
        try:
            last = self._last            # re-check under the guard
            if not force and last is not None \
                    and t - last < self.interval:
                return False
            self._last = t
            self._sample(t)
            self._sweep()
            return True
        finally:
            self._tick_lock.release()

    def _sample(self, t: float) -> None:
        self.samples += 1
        ch = self._charge
        if ch is not None:
            ch.metric_sample()
        for name, fn in self._probes:
            try:
                val = fn()
            except Exception:
                continue                 # a dying probe never kills a tick
            if isinstance(val, dict):
                for sub, v in val.items():
                    self._append(f"{name}.{sub}", t, v)
            elif val is not None:
                self._append(name, t, val)

    def _append(self, name: str, t: float, v) -> None:
        ring = self.series.get(name)
        if ring is None:
            ring = self.series[name] = deque(maxlen=self.window)
        ring.append((t, float(v)))

    def _sweep(self) -> None:
        det, tr = self.detector, self.tracer
        if det is None or tr is None or not getattr(tr, "enabled", False):
            return
        appended = tr.total_appended
        if appended <= self._trace_seen:
            return                       # no fresh events since last sweep
        self._trace_seen = appended
        fresh = det.sweep(tr.events())
        if fresh:
            self.live_findings.extend(fresh)
            cb = self.on_findings
            if cb is not None:
                try:
                    cb(fresh)
                except Exception:
                    pass

    # -- read side ------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        # serialize against ticks: iterating a deque a concurrent
        # sample is appending to raises. Ticks never block on this —
        # they try-lock and skip (one missed sample per racing read).
        with self._tick_lock:
            return {
                "interval": self.interval,
                "window": self.window,
                "samples": self.samples,
                "series": {name: [[t, v] for t, v in ring]
                           for name, ring in self.series.items()},
                "live_findings": [
                    {"kind": f.kind, "t0": f.t0, "t1": f.t1,
                     "slot": f.slot, "count": f.count}
                    for f in self.live_findings],
            }
