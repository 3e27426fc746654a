"""Copy of `repro/core/engine/placement.py`.

Back-compat shim: placement policies moved into the unified
scheduling subsystem (:mod:`repro_torch.core.sched.placement`), next to the
DAG core that powers ``CriticalPathPlacement``. Import from
``repro_torch.core.sched`` in new code."""
from ..sched.placement import (PLACEMENT_NAMES, CriticalPathPlacement,
                               PlacementPolicy, RoundRobinPlacement,
                               ShardAffinePlacement, make_placement)

__all__ = [
    "PLACEMENT_NAMES", "PlacementPolicy", "RoundRobinPlacement",
    "ShardAffinePlacement", "CriticalPathPlacement", "make_placement",
]
