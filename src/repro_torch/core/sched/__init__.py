"""DAG helpers for the serving engine's admission order."""
from .dag import DagNode, bottom_levels, build_arrays

__all__ = ["DagNode", "bottom_levels", "build_arrays"]
