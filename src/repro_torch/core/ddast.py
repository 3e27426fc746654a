"""Copy of `repro/core/ddast.py`.

DDAST tunables (paper §3.3, Table 5).

The Distributed DAS Thread manager itself — the Listing-2 callback any
idle worker enters to become a *manager thread* — lives in
``core.engine.policy`` as :class:`~repro_torch.core.engine.policy.DdastPolicy`
(with the centralized [7] variant as ``DastPolicy`` and the sharded
extension as ``ShardedPolicy``), so the drain protocol is shared between
the threaded runtime and the virtual-time simulator. This module keeps
the four tunables and the tuned defaults from Table 5:

    MAX_DDAST_THREADS  = ceil(num_threads / 8)      (initial: inf)
    MAX_SPINS          = 1                           (initial: 20)
    MAX_OPS_THREAD     = 8                           (initial: 6)
    MIN_READY_TASKS    = 4                           (initial: 4)

``DDASTManager`` remains importable here as an alias of ``DdastPolicy``
(resolved lazily to avoid a circular import with the engine package).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class DDASTParams:
    max_ddast_threads: Optional[int] = None  # None -> ceil(num_threads/8)
    max_spins: int = 1
    max_ops_thread: int = 8
    min_ready_tasks: int = 4
    # Scope-fair drain rotation: max dependence-analysis portions one
    # scope may consume per drain pass (ddast queue sweep / sharded
    # combine session) before the drainer rotates to another tenant's
    # backlog. 0 disables the quantum (pure FIFO drain order).
    drain_quantum: int = 16

    def resolved_max_threads(self, num_threads: int) -> int:
        if self.max_ddast_threads is None:
            return max(1, math.ceil(num_threads / 8))
        return self.max_ddast_threads

    @staticmethod
    def initial() -> "DDASTParams":
        """Pre-tuning values (Table 5, 'Initial Value' column)."""
        return DDASTParams(max_ddast_threads=1 << 30, max_spins=20,
                           max_ops_thread=6, min_ready_tasks=4)


def __getattr__(name: str):
    if name == "DDASTManager":
        from .engine.policy import DdastPolicy
        return DdastPolicy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
