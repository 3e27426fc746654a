"""Copy of `repro/core/sched/__init__.py`.

Unified scheduling subsystem.

One DAG core (:mod:`~repro_torch.core.sched.dag`: successor arrays, bottom
levels, the DDAST-discipline list-schedule event loop) shared by the two
scheduling layers that previously duplicated it:

  * **static** (:mod:`~repro_torch.core.sched.static`) — ``ddast_schedule`` /
    ``overlap_collectives`` order device-side DAGs for the train and
    serve consumers (XLA fixes the schedule at compile time, so only the
    *order* transfers);
  * **dynamic** (:mod:`~repro_torch.core.sched.placement`) — the
    ``PlacementPolicy`` family owning the per-worker two-lane
    ``StealDeque`` ready pools, including ``CriticalPathPlacement``,
    which schedules frozen replay graphs along their critical paths
    (bottom levels computed once at freeze time from the recorded
    successor arrays and per-task cost EMAs).

        record ──▶ freeze ──▶ prioritize ──▶ replay
        (live      (resolve    (bottom        (priority-lane push,
        analysis)   deps once)  levels/bands)  two-lane pops)
"""
from .dag import (DagNode, bottom_levels, build_arrays, list_schedule,
                  quantize_bands)
from .placement import (PLACEMENT_NAMES, CriticalPathPlacement,
                        PlacementPolicy, RoundRobinPlacement,
                        ShardAffinePlacement, make_placement)
from .static import ddast_schedule, overlap_collectives

__all__ = [
    "DagNode", "bottom_levels", "build_arrays", "list_schedule",
    "quantize_bands",
    "PLACEMENT_NAMES", "PlacementPolicy", "RoundRobinPlacement",
    "ShardAffinePlacement", "CriticalPathPlacement", "make_placement",
    "ddast_schedule", "overlap_collectives",
]
