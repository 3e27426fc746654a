"""Core of the port: the paper's asynchronous runtime organization with a
distributed manager (DDAST), copied from `repro/core` so the port imports
nothing of the JAX package. Each file names its source.

The threaded ``TaskRuntime`` is ported whole: the four dependence
organizations (``sync``, ``dast``, ``ddast``, ``sharded``) behind the
mode-agnostic dependence-policy engine (``core.engine``), record and
replay, multi-tenant ``JobScope``s with weighted-fair admission, tracing
(``core.trace``) and the live metrics plane (``core.metrics``); so are
the virtual-time ``RuntimeSimulator`` over the same policies
(``core.simulator``), the ``DynamicTuner`` (``core.autotune``) and the
paper's three applications (``core.taskgraph_apps``: blocked Matmul,
nested N-Body and Sparse LU, whose task bodies are PyTorch calls on the
caller's device and stream); and the process backend
(``core.procs``: ``TaskRuntime(backend="processes")`` returns a
``ProcessRuntime``, whose workers start from a fork server and may each
hold a CUDA context, with tensors on the card shared by CUDA IPC).
"""
from .autotune import DynamicTuner, TunerConfig
from .ddast import DDASTManager, DDASTParams
from .depgraph import DependenceGraph
from .dispatcher import FunctionalityDispatcher
from .engine import (CostCharger, CriticalPathPlacement, DastPolicy,
                     DdastPolicy, DependencePolicy, PlacementPolicy,
                     ReplayGraph, ReplayPolicy, RoundRobinPlacement,
                     ShardAffinePlacement, ShardedPolicy, SimCharger,
                     SyncPolicy, make_placement, make_policy)
from .errors import RingCorruption, ScopeExpired, TaskFailed, WorkerLost
from .messages import (DoneBatchMessage, DoneTaskMessage,
                       SubmitBatchMessage, SubmitTaskMessage)
from .queues import InstrumentedLock, SPSCQueue, WorkerQueues
from .procs import FaultPlan, ProcessRuntime, ShmRing
from .runtime import RuntimeStats, TaskRuntime
from .sched import bottom_levels, list_schedule, quantize_bands
from .scopes import (FairAdmission, JobScope, ScopedPolicy, ScopedRegion,
                     scoped_deps)
from .shards import (AtomicCounter, GraphShard, ShardMailbox, ShardRouter,
                     ShardedDependenceGraph, StealDeque, stable_region_hash)
from .simulator import RuntimeSimulator, SimCosts, SimResult, SimTaskSpec
from .static_sched import DagNode, ddast_schedule, overlap_collectives
from .trace import (Finding, TraceEvent, TraceRecorder, detect_all,
                    load_trace, save_trace)
from .wd import DepMode, TaskState, WorkDescriptor

__all__ = [
    "DynamicTuner", "TunerConfig",
    "DDASTManager", "DDASTParams", "DependenceGraph",
    "FunctionalityDispatcher",
    "CostCharger", "SimCharger",
    "DependencePolicy", "SyncPolicy", "DastPolicy", "DdastPolicy",
    "ShardedPolicy", "ReplayPolicy", "ReplayGraph", "make_policy",
    "PlacementPolicy", "RoundRobinPlacement", "ShardAffinePlacement",
    "CriticalPathPlacement", "make_placement",
    "ProcessRuntime", "ShmRing", "TaskFailed", "WorkerLost",
    "FaultPlan", "RingCorruption", "ScopeExpired",
    "DoneBatchMessage", "DoneTaskMessage", "SubmitBatchMessage",
    "SubmitTaskMessage",
    "InstrumentedLock", "SPSCQueue", "WorkerQueues",
    "RuntimeStats", "TaskRuntime",
    "bottom_levels", "list_schedule", "quantize_bands",
    "FairAdmission", "JobScope", "ScopedPolicy", "ScopedRegion",
    "scoped_deps",
    "AtomicCounter", "GraphShard", "ShardMailbox", "ShardRouter",
    "ShardedDependenceGraph", "StealDeque", "stable_region_hash",
    "RuntimeSimulator", "SimCosts", "SimResult", "SimTaskSpec",
    "DagNode", "ddast_schedule", "overlap_collectives",
    "Finding", "TraceEvent", "TraceRecorder", "detect_all",
    "load_trace", "save_trace",
    "DepMode", "TaskState", "WorkDescriptor",
]
