"""Functionality Dispatcher (paper §3.2, Fig. 4): copy of
`repro/core/dispatcher.py`.

A runtime-core module mediating between subsystems: any module registers a
callback during init (or mid-run); worker threads that become idle notify
the dispatcher, which hands them a registered callback to execute. This is
how runtime functionality runs WITHOUT dedicated resources — the DDAST
manager is simply one registered callback; this framework also registers
async checkpoint flushing, data prefetch and metric flushing (DESIGN.md §2).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List


@dataclass
class _Callback:
    name: str
    fn: Callable[[int], None]     # receives the idle worker's id
    priority: int = 0
    calls: int = 0


class FunctionalityDispatcher:
    def __init__(self) -> None:
        self._callbacks: List[_Callback] = []
        self._quiescent: List[_Callback] = []
        self._lock = threading.Lock()

    def register(self, name: str, fn: Callable[[int], None],
                 priority: int = 0) -> None:
        with self._lock:
            self._callbacks.append(_Callback(name, fn, priority))
            self._callbacks.sort(key=lambda c: -c.priority)

    def register_quiescent(self, name: str, fn: Callable[[int], None],
                           priority: int = 0) -> None:
        """Register a callback run at taskwait quiescence (the blocked
        thread observed zero live children and zero pending messages) —
        the only moments global reconfiguration (e.g. shard-count
        retuning) is safe."""
        with self._lock:
            self._quiescent.append(_Callback(name, fn, priority))
            self._quiescent.sort(key=lambda c: -c.priority)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._callbacks = [c for c in self._callbacks if c.name != name]
            self._quiescent = [c for c in self._quiescent if c.name != name]

    def notify_idle(self, worker_id: int) -> bool:
        """An idle worker offers itself; run registered callbacks (highest
        priority first). Returns True if any callback ran."""
        ran = False
        for cb in list(self._callbacks):
            cb.fn(worker_id)
            cb.calls += 1
            ran = True
        return ran

    def notify_quiescent(self, worker_id: int) -> bool:
        """A taskwait reached quiescence on ``worker_id``'s thread."""
        ran = False
        for cb in list(self._quiescent):
            cb.fn(worker_id)
            cb.calls += 1
            ran = True
        return ran

    def stats(self) -> Dict[str, int]:
        return {c.name: c.calls
                for c in self._callbacks + self._quiescent}
