"""Copy of `repro/core/errors.py`.

Structured runtime failures shared by both drivers.

The fault-tolerance contract (paper §3: dependence state lives in the
manager, workers are expendable) needs one vocabulary of failures that
the threaded driver, the process driver, the scopes layer, and the ring
transport all agree on — and that tests can import without touching a
driver module. Every exception here is raised at a *quiescence point*
(a ``taskwait``), never from inside a worker, so the dependence graph
is always consistent when user code sees it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


class WorkerLost(RuntimeError):
    """A worker process died with non-retryable task(s) in flight
    (``retries=0``, the default). Raised at the next ``taskwait``
    (instead of hanging its quiescence wait) naming the in-flight
    task(s). Tasks submitted with ``retries=N`` never surface this:
    the supervisor respawns the worker and re-dispatches them."""


class TaskFailed(RuntimeError):
    """A task body raised, or a retryable task exhausted its retry
    budget (poisoned). Carries the traceback(s) and, for poisoned
    tasks, the per-attempt history; raised at the owning scope's
    ``taskwait`` after quiescence (the graph stays consistent: the
    failing task completes, successors run)."""

    def __init__(self, msg: str, failures: Optional[Sequence] = None
                 ) -> None:
        super().__init__(msg)
        #: list of (label, traceback_or_reason, attempts) tuples — the
        #: structured form of the message, one entry per failed task
        self.failures: List = list(failures or [])


class ScopeExpired(RuntimeError):
    """A :class:`~repro_torch.core.scopes.JobScope` exceeded its ``deadline=``
    (wall seconds since open) or ``budget=`` (summed body-execution
    seconds). The scope's own unrun tasks are drained and failed;
    other tenants are untouched. Raised once, at the expired scope's
    ``taskwait``."""

    def __init__(self, msg: str, scope: Optional[str] = None,
                 reason: Optional[str] = None, drained: int = 0) -> None:
        super().__init__(msg)
        self.scope = scope
        self.reason = reason            # "deadline" | "budget"
        self.drained = drained          # tasks skipped without running


class RingCorruption(RuntimeError):
    """A shared-memory ring frame failed its CRC32 check. The consumer
    advances past the frame before raising, so the transport stays
    usable; the process driver treats it as a worker fault (the
    producing worker is killed and respawned, its in-flight tasks
    retried or poisoned)."""

    def __init__(self, msg: str, ring: Optional[str] = None,
                 expected: int = 0, actual: int = 0) -> None:
        super().__init__(msg)
        self.ring = ring
        self.expected = expected
        self.actual = actual
