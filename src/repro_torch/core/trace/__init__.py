"""Copy of `repro/core/trace/__init__.py`.

Low-overhead per-task event tracing + detrimental-pattern detection.

``recorder`` is the shared recording layer (per-slot GIL-atomic ring
buffers, one schema for the threaded and simulated drivers); ``detect``
holds the three pathology detectors (ready-queue starvation, priority
inversion, affinity misses) that feed the ``DynamicTuner`` via its
quiescence hook and the ``repro_torch.analysis.traceview`` exporter.
``spans`` (the port's own, with no JAX counterpart) marks the layers of
a step as profiler ranges while a PyTorch profiler records.
"""
from .detect import (AFFINITY_MISS, INVERSION, STARVATION, Finding,
                     IncrementalDetector, detect_affinity_misses,
                     detect_all, detect_priority_inversion,
                     detect_starvation, replay_windows)
from .recorder import (EV_ADMIT_DEFER, EV_COMBINE, EV_CREATED,
                       EV_DELEGATE, EV_DEPS, EV_END, EV_MSG_DRAIN,
                       EV_MSG_ENQ, EV_QUIESCE, EV_READY, EV_RESPAWN,
                       EV_RETRY, EV_SCOPE_EXPIRED, EV_START, EV_STEAL,
                       EV_TIMEOUT_KILL, EV_TRACE_LOST, EV_WORKER_LOST,
                       FAULT_EVENTS, NULL_TRACER, TASK_LIFECYCLE,
                       NullTraceRecorder, TraceEvent, TraceRecorder,
                       load_trace, replay_iterations_of, save_trace)
from .spans import span

__all__ = [
    "TraceRecorder", "NullTraceRecorder", "NULL_TRACER", "TraceEvent",
    "load_trace", "save_trace", "replay_iterations_of", "TASK_LIFECYCLE",
    "EV_CREATED", "EV_DEPS", "EV_READY", "EV_START", "EV_END",
    "EV_MSG_ENQ", "EV_MSG_DRAIN", "EV_DELEGATE", "EV_COMBINE",
    "EV_STEAL", "EV_ADMIT_DEFER", "EV_QUIESCE",
    "EV_WORKER_LOST", "EV_RESPAWN", "EV_RETRY", "EV_TIMEOUT_KILL",
    "EV_SCOPE_EXPIRED", "EV_TRACE_LOST", "FAULT_EVENTS",
    "Finding", "IncrementalDetector", "detect_all", "detect_starvation",
    "detect_priority_inversion", "detect_affinity_misses",
    "replay_windows", "STARVATION", "INVERSION", "AFFINITY_MISS",
    "span",
]
