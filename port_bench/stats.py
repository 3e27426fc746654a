"""End-to-end statistics over a whole window: never a median of pieces."""
from __future__ import annotations

import statistics
from typing import Sequence


def rate(units: float, seconds: float) -> float:
    """Work completed in the window over the window's wall."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return units / seconds


def percentile(samples: Sequence[float], pct: int) -> float:
    """The pct-th percentile of every sample (`statistics.quantiles`,
    inclusive method: linear between the two nearest order statistics)."""
    if len(samples) < 2:
        raise ValueError(f"{len(samples)} samples: no percentile")
    return statistics.quantiles(samples, n=100, method="inclusive")[pct - 1]
