"""Core of the port: the paper's asynchronous runtime organization with a
distributed manager (DDAST), copied from `repro/core` so the port imports
nothing of the JAX package. Each file names its source.

The threaded ``TaskRuntime`` is ported whole: the four dependence
organizations (``sync``, ``dast``, ``ddast``, ``sharded``) behind the
mode-agnostic dependence-policy engine (``core.engine``), record and
replay, multi-tenant ``JobScope``s with weighted-fair admission, tracing
(``core.trace``) and the live metrics plane (``core.metrics``). Not
ported: the process backend (``TaskRuntime(backend="processes")``
raises), the virtual-time simulator and the autotuner.
"""
from .ddast import DDASTManager, DDASTParams
from .depgraph import DependenceGraph
from .dispatcher import FunctionalityDispatcher
from .engine import (CostCharger, CriticalPathPlacement, DastPolicy,
                     DdastPolicy, DependencePolicy, PlacementPolicy,
                     ReplayGraph, ReplayPolicy, RoundRobinPlacement,
                     ShardAffinePlacement, ShardedPolicy, SyncPolicy,
                     make_placement, make_policy)
from .errors import ScopeExpired, TaskFailed
from .messages import (DoneBatchMessage, DoneTaskMessage,
                       SubmitBatchMessage, SubmitTaskMessage)
from .queues import InstrumentedLock, SPSCQueue, WorkerQueues
from .runtime import RuntimeStats, TaskRuntime
from .sched import (DagNode, bottom_levels, ddast_schedule, list_schedule,
                    overlap_collectives, quantize_bands)
from .scopes import (FairAdmission, JobScope, ScopedPolicy, ScopedRegion,
                     scoped_deps)
from .shards import (AtomicCounter, GraphShard, ShardMailbox, ShardRouter,
                     ShardedDependenceGraph, StealDeque, stable_region_hash)
from .trace import (Finding, TraceEvent, TraceRecorder, detect_all,
                    load_trace, save_trace)
from .wd import DepMode, TaskState, WorkDescriptor

__all__ = [
    "DDASTManager", "DDASTParams", "DependenceGraph",
    "FunctionalityDispatcher",
    "CostCharger",
    "DependencePolicy", "SyncPolicy", "DastPolicy", "DdastPolicy",
    "ShardedPolicy", "ReplayPolicy", "ReplayGraph", "make_policy",
    "PlacementPolicy", "RoundRobinPlacement", "ShardAffinePlacement",
    "CriticalPathPlacement", "make_placement",
    "ScopeExpired", "TaskFailed",
    "DoneBatchMessage", "DoneTaskMessage", "SubmitBatchMessage",
    "SubmitTaskMessage",
    "InstrumentedLock", "SPSCQueue", "WorkerQueues",
    "RuntimeStats", "TaskRuntime",
    "DagNode", "bottom_levels", "ddast_schedule", "list_schedule",
    "overlap_collectives", "quantize_bands",
    "FairAdmission", "JobScope", "ScopedPolicy", "ScopedRegion",
    "scoped_deps",
    "AtomicCounter", "GraphShard", "ShardMailbox", "ShardRouter",
    "ShardedDependenceGraph", "StealDeque", "stable_region_hash",
    "Finding", "TraceEvent", "TraceRecorder", "detect_all",
    "load_trace", "save_trace",
    "DepMode", "TaskState", "WorkDescriptor",
]
