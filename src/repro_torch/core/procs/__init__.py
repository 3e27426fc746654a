"""Copy of `repro/core/procs/__init__.py`.

Multi-process backend (``backend="processes"``): worker processes
execute task bodies while the shard-pinned manager stack stays in the
parent; cross-process traffic is the §3.1 message shapes in compact
binary form over shared-memory SPSC rings; frozen replay graphs map
into every worker so steady-state replayed iterations ship only latch
generations. Workers start from a fork server (never ``fork``), each
may hold its own CUDA context, and ``apps.DeviceArray`` shares tensors
on the card by CUDA IPC. See ``driver.py`` for the full design notes."""
from .chaos import FaultPlan
from .driver import (ProcessDispatch, ProcessRuntime, TaskFailed,
                     WorkerLost)
from .rings import RingCorruption, ShmRing, attach_shm

__all__ = ["ProcessRuntime", "ProcessDispatch", "WorkerLost",
           "TaskFailed", "FaultPlan", "RingCorruption", "ShmRing",
           "attach_shm"]
