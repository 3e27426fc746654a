"""DAG helpers: the serving engine's admission order and the static
DDAST schedule of the train step's microbatches."""
from .dag import DagNode, bottom_levels, build_arrays, list_schedule
from .static import ddast_schedule, overlap_collectives

__all__ = ["DagNode", "bottom_levels", "build_arrays", "list_schedule",
           "ddast_schedule", "overlap_collectives"]
