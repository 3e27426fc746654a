"""Copy of `repro/core/engine/__init__.py`.

Unified dependence-policy engine.

One mode-agnostic core shared by the threaded ``TaskRuntime`` and the
virtual-time ``RuntimeSimulator``:

    ┌──────────────────────────┐   ┌──────────────────────────────┐
    │ TaskRuntime (threads)    │   │ RuntimeSimulator (virtual t) │
    │   CostCharger (no-op)    │   │   SimCharger (VirtualLocks)  │
    └────────────┬─────────────┘   └──────────────┬───────────────┘
                 └───────────── drives ───────────┘
                   ┌────────────────▼────────────────┐
                   │        DependencePolicy         │
                   │ Sync · Dast · Ddast · Sharded   │
                   └──┬───────────────────────────┬──┘
                      ▼                           ▼
             PlacementPolicy               graph structures
        (RoundRobin / ShardAffine       (DependenceGraph · shards:
         over per-slot StealDeques)      ShardedDependenceGraph,
                                         ShardRouter mailboxes)
"""
from .charge import CostCharger, SimCharger, VirtualLock
from .placement import (PLACEMENT_NAMES, CriticalPathPlacement,
                        PlacementPolicy, RoundRobinPlacement,
                        ShardAffinePlacement, make_placement)
from .policy import (POLICY_NAMES, DastPolicy, DdastPolicy,
                     DependencePolicy, ShardedPolicy, SyncPolicy,
                     make_policy, mode_needs_manager_thread,
                     mode_uses_shards)
from .replay import ReplayGraph, ReplayPolicy

__all__ = [
    "CostCharger", "SimCharger", "VirtualLock",
    "PLACEMENT_NAMES", "PlacementPolicy", "RoundRobinPlacement",
    "ShardAffinePlacement", "CriticalPathPlacement", "make_placement",
    "POLICY_NAMES", "DependencePolicy", "SyncPolicy", "DastPolicy",
    "DdastPolicy", "ShardedPolicy", "make_policy", "mode_uses_shards",
    "mode_needs_manager_thread",
    "ReplayGraph", "ReplayPolicy",
]
