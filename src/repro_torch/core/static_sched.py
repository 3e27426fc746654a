"""Copy of `repro/core/static_sched.py`.

Back-compat shim: the static DDAST scheduler moved into the unified
scheduling subsystem (:mod:`repro_torch.core.sched`), where it shares its DAG
core (successor arrays, list-schedule event loop, bottom levels) with
the runtime's critical-path replay placement. Import from
``repro_torch.core.sched`` in new code."""
from .sched.dag import DagNode
from .sched.static import ddast_schedule, overlap_collectives

__all__ = ["DagNode", "ddast_schedule", "overlap_collectives"]
