"""Copy of `repro/core/metrics/__init__.py`.

Live metrics plane: lock-free per-slot instruments, a
dispatcher-riding time-series sampler, per-scope SLO attainment, and
Prometheus / Perfetto exporters.

Layering: this package imports nothing from the rest of ``repro_torch.core``
(so ``scopes``, ``runtime``, ``procs`` and ``serve`` can all depend on
it without cycles). The incremental detector lives in ``core.trace``
next to its batch siblings; the sampler takes it by injection.
"""
from .instruments import (LogHistogram, MetricsHub, NullMetricsHub,
                          NULL_METRICS, SlotCounter, SlotGauge,
                          ThreadClock)
from .sampler import MetricsSampler
from .export import (counter_track_events, load_metrics,
                     prometheus_text, save_metrics)
from .shm_plane import PLANE_FIELDS, ShmCounterPlane, WorkerCounterView

__all__ = [
    "LogHistogram", "MetricsHub", "NullMetricsHub", "NULL_METRICS",
    "SlotCounter", "SlotGauge", "ThreadClock",
    "MetricsSampler",
    "counter_track_events", "load_metrics", "prometheus_text",
    "save_metrics",
    "PLANE_FIELDS", "ShmCounterPlane", "WorkerCounterView",
]
