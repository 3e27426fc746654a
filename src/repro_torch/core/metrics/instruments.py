"""Copy of `repro/core/metrics/instruments.py`.

Live instruments: per-slot counters, gauges and log-bucketed
latency histograms.

Same discipline as ``core.trace.recorder``: every hot-path write is a
single GIL-atomic operation on a slot owned by exactly one thread (a
plain ``list.__setitem__`` / int ``+=`` on CPython is one bytecode-level
store under the GIL, and per-slot single-writer means there is nothing
to race even without it), and the disabled path is one attribute check
on a shared ``NULL_METRICS`` singleton. Aggregation — summing slots,
merging histograms — happens lazily at read time on whichever thread
asks, never on the task path. Zero locks are introduced anywhere in
this module.

The histogram is HDR-style log-bucketed: values are quantized to a
``resolution``, small values get exact buckets, larger values land in
buckets of 4 per power of two, so the relative bucket width is bounded
by 25% at any magnitude. Buckets are a sparse dict (most workloads
touch a handful), merge is element-wise addition (associative and
commutative — the property the merge tests gate), and quantiles report
the bucket's upper bound, so ``quantile(q)`` is always >= the exact
q-quantile and <= ``exact * 1.25 + resolution``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

__all__ = ["LogHistogram", "SlotCounter", "SlotGauge", "ThreadClock",
           "MetricsHub", "NullMetricsHub", "NULL_METRICS"]


class LogHistogram:
    """Sparse log-bucketed histogram. Single-writer (``record``) per
    instance; any thread may snapshot/merge (worst case it reads a
    torn-but-valid partial count, same contract as the tracer)."""

    __slots__ = ("resolution", "counts", "count", "total", "min", "max")

    def __init__(self, resolution: float = 1e-6) -> None:
        self.resolution = resolution
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    # -- bucket math ----------------------------------------------------
    @staticmethod
    def _index(v: int) -> int:
        # v is the quantized value (units of `resolution`), >= 0.
        # 0..3 exact; beyond that 4 buckets per power of two: the
        # exponent e = bit_length-3 keeps the top 3 bits, mantissa 4..7.
        if v < 4:
            return v
        e = v.bit_length() - 3
        return 4 * (e + 1) + ((v >> e) - 4)

    def _bounds(self, idx: int) -> tuple:
        """(lo, hi) of bucket ``idx`` in value units; hi is exclusive
        and is the conservative quantile answer."""
        if idx < 4:
            lo, hi = idx, idx + 1
        else:
            e = idx // 4 - 1
            m = idx % 4 + 4
            lo = m << e
            hi = (m + 1) << e
        return lo * self.resolution, hi * self.resolution

    # -- hot path -------------------------------------------------------
    def record(self, value: float) -> None:
        v = int(value / self.resolution)
        if v < 0:
            v = 0
        idx = self._index(v)
        c = self.counts
        c[idx] = c.get(idx, 0) + 1
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    # -- read side ------------------------------------------------------
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Element-wise sum into a NEW histogram (inputs untouched).
        Requires equal resolutions; associative and commutative.

        ``other``'s buckets are copied by one C-level ``tuple()`` call
        before the loop: its writer may add a bucket meanwhile, and the
        loop over the live dict (the JAX package's copy) then raised
        "dictionary changed size during iteration" in a reader of
        ``TaskRuntime.metrics()``."""
        if other.resolution != self.resolution:
            raise ValueError("histogram resolutions differ: "
                             f"{self.resolution} vs {other.resolution}")
        out = LogHistogram(self.resolution)
        out.counts = dict(self.counts)
        for idx, n in tuple(other.counts.items()):
            out.counts[idx] = out.counts.get(idx, 0) + n
        out.count = self.count + other.count
        out.total = self.total + other.total
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    def quantile(self, q: float) -> float:
        """Conservative q-quantile: upper bound of the bucket holding
        the ceil(q*count)-th sample. 0.0 when empty."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        target = max(int(q * self.count + 0.999999), 1)
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= target:
                return self._bounds(idx)[1]
        return self._bounds(max(self.counts))[1]

    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly view: sorted ``[lo, hi, n]`` bucket rows plus
        the scalar moments."""
        rows = [[*self._bounds(idx), n]
                for idx, n in sorted(self.counts.items())]
        return {"count": self.count,
                "sum": self.total,
                "min": self.min if self.count else 0.0,
                "max": self.max,
                "resolution": self.resolution,
                "buckets": rows}

    @staticmethod
    def merge_all(hists: List["LogHistogram"]) -> "LogHistogram":
        if not hists:
            return LogHistogram()
        out = hists[0]
        for h in hists[1:]:
            out = out.merge(h)
        return out


class SlotCounter:
    """Monotonic per-slot counter; writes from slot *i* only ever touch
    ``per_slot[i]`` (GIL-atomic), reads sum lazily. Index ``num_slots``
    is the shared overflow slot for unattributed writers (same layout
    as the tracer's overflow ring)."""

    __slots__ = ("per_slot",)

    def __init__(self, num_slots: int) -> None:
        self.per_slot: List[int] = [0] * (num_slots + 1)

    def add(self, slot: int, delta: int = 1) -> None:
        p = self.per_slot
        n = len(p) - 1
        p[slot if 0 <= slot < n else n] += delta

    @property
    def total(self) -> int:
        return sum(self.per_slot)


class SlotGauge:
    """Per-slot last-value gauge (e.g. busy flags); ``total`` sums."""

    __slots__ = ("per_slot",)

    def __init__(self, num_slots: int) -> None:
        self.per_slot: List[float] = [0.0] * (num_slots + 1)

    def set(self, slot: int, value: float) -> None:
        p = self.per_slot
        n = len(p) - 1
        p[slot if 0 <= slot < n else n] = value

    @property
    def total(self) -> float:
        return sum(self.per_slot)


class ThreadClock:
    """Calls, wall seconds (``perf_counter``) and the calling thread's CPU
    seconds (``time.thread_time``) of a region that one thread at a time
    enters: ``with clock: ...``. Wall minus CPU is the time the thread
    spent off the CPU inside the region: waiting for the GIL, blocked, or
    preempted. Four clock reads a call; single-writer like the counters
    above, and any thread may ``read()`` the totals. The port's own (the
    JAX package has no stepping thread beside its runtime to time)."""

    __slots__ = ("calls", "wall_s", "cpu_s", "_t0")

    def __init__(self) -> None:
        self.calls = 0
        self.wall_s = 0.0
        self.cpu_s = 0.0
        self._t0 = (0.0, 0.0)

    def __enter__(self) -> "ThreadClock":
        # the CPU clock is read inside the wall clock's interval, so a
        # call's wall is never shorter than its CPU time
        self._t0 = (time.perf_counter(), time.thread_time())
        return self

    def __exit__(self, *exc) -> None:
        cpu = time.thread_time()
        wall = time.perf_counter()
        w0, c0 = self._t0
        self.wall_s += wall - w0
        self.cpu_s += cpu - c0
        self.calls += 1

    def read(self) -> tuple:
        """(calls, wall seconds, CPU seconds) so far."""
        return self.calls, self.wall_s, self.cpu_s


class MetricsHub:
    """The driver-side instrument bundle: task start/finish counters,
    busy flags, summed exec time and a latency histogram — all per
    slot, all single-writer, aggregated only in :meth:`snapshot`.

    ``charge`` is the simulator's :class:`SimCharger` (or ``None`` on
    real drivers): each instrument write prices one ``metric_event`` of
    local virtual time so the overhead gate measures a real cost, the
    same contract as ``TraceRecorder``.
    """

    enabled = True

    def __init__(self, num_slots: int, clock: Callable[[], float],
                 charge=None, time_unit: str = "s",
                 latency_resolution: Optional[float] = None) -> None:
        self.num_slots = num_slots
        self.clock = clock
        self.time_unit = time_unit
        self._charge = charge
        if latency_resolution is None:
            latency_resolution = 1.0 if time_unit == "us" else 1e-6
        self.tasks_started = [0] * (num_slots + 1)
        self.tasks_finished = [0] * (num_slots + 1)
        self.exec_time = [0.0] * (num_slots + 1)
        self.busy = [0] * (num_slots + 1)
        self.latency = [LogHistogram(latency_resolution)
                        for _ in range(num_slots + 1)]

    def _clamp(self, slot: int) -> int:
        return slot if 0 <= slot < self.num_slots else self.num_slots

    # -- hot path -------------------------------------------------------
    def task_start(self, slot: int) -> None:
        s = self._clamp(slot)
        self.tasks_started[s] += 1
        self.busy[s] = 1
        ch = self._charge
        if ch is not None:
            ch.metric_event()

    def task_end(self, slot: int, dur: float) -> None:
        s = self._clamp(slot)
        self.tasks_finished[s] += 1
        self.exec_time[s] += dur
        self.latency[s].record(dur)
        self.busy[s] = 0
        ch = self._charge
        if ch is not None:
            ch.metric_event()

    # -- read side ------------------------------------------------------
    def busy_fraction(self, num_workers: Optional[int] = None) -> float:
        n = num_workers if num_workers is not None else self.num_slots
        if n <= 0:
            return 0.0
        return sum(self.busy[:n]) / n

    def snapshot(self) -> Dict[str, object]:
        merged = LogHistogram.merge_all(list(self.latency))
        return {
            "time_unit": self.time_unit,
            "counters": {
                "tasks_started": {"total": sum(self.tasks_started),
                                  "per_slot": list(self.tasks_started)},
                "tasks_finished": {"total": sum(self.tasks_finished),
                                   "per_slot": list(self.tasks_finished)},
            },
            "exec_time": {"total": sum(self.exec_time),
                          "per_slot": list(self.exec_time)},
            "busy_slots": list(self.busy),
            "task_latency": merged.snapshot(),
        }


class NullMetricsHub:
    """Metrics-off singleton: one ``.enabled`` check is the entire
    disabled-path cost (gated by the no-op cost test)."""

    enabled = False
    num_slots = 0

    def task_start(self, slot: int) -> None:
        pass

    def task_end(self, slot: int, dur: float) -> None:
        pass

    def busy_fraction(self, num_workers=None) -> float:
        return 0.0

    def snapshot(self) -> Dict[str, object]:
        return {}


NULL_METRICS = NullMetricsHub()
