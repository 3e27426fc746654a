"""Named host spans inside the port's step, on the PyTorch profiler's clock.

The JAX package has no counterpart to this file: its tracing records the
runtime's tasks (`recorder.py`), and a jitted step has no host layers to
mark.

`span(name)` returns `torch.profiler.record_function(name)` while the
PyTorch profiler records (`torch.autograd.profiler._is_profiler_enabled`)
and one shared no-op context manager otherwise, so an unprofiled span
costs one attribute check and builds nothing. There is no switch: a span
is on exactly when a profiler records. A range goes into the same Chrome
trace as the kernels, on the same clock, so the device time of the
operations launched inside it needs no alignment. Every name is
`port.<layer>.<what>`.

A range entered on a Python thread that the profiler does not follow is
not recorded (its callbacks are thread-local; the autograd engine's
device threads inherit them, the runtime's worker threads do not). So the
runtime's workers keep counters (`core.metrics`), not spans.
"""
from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` while a profiler records,
    and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
