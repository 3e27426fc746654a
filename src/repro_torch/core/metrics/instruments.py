"""Log-bucketed latency histogram: copy of `LogHistogram` from
`repro/core/metrics/instruments.py`.

The histogram is HDR-style log-bucketed: values are quantized to a
``resolution``, small values get exact buckets, larger values land in
buckets of 4 per power of two, so the relative bucket width is bounded
by 25% at any magnitude. Buckets are a sparse dict, merge is element-wise
addition, and quantiles report the bucket's upper bound, so
``quantile(q)`` is always >= the exact q-quantile and
<= ``exact * 1.25 + resolution``. Single writer per instance.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["LogHistogram"]


class LogHistogram:
    """Sparse log-bucketed histogram. Single-writer (``record``) per
    instance; any thread may snapshot/merge (worst case it reads a
    torn-but-valid partial count, same contract as the tracer)."""

    __slots__ = ("resolution", "counts", "count", "total", "min", "max")

    def __init__(self, resolution: float = 1e-6) -> None:
        self.resolution = resolution
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    # -- bucket math ----------------------------------------------------
    @staticmethod
    def _index(v: int) -> int:
        # v is the quantized value (units of `resolution`), >= 0.
        # 0..3 exact; beyond that 4 buckets per power of two: the
        # exponent e = bit_length-3 keeps the top 3 bits, mantissa 4..7.
        if v < 4:
            return v
        e = v.bit_length() - 3
        return 4 * (e + 1) + ((v >> e) - 4)

    def _bounds(self, idx: int) -> tuple:
        """(lo, hi) of bucket ``idx`` in value units; hi is exclusive
        and is the conservative quantile answer."""
        if idx < 4:
            lo, hi = idx, idx + 1
        else:
            e = idx // 4 - 1
            m = idx % 4 + 4
            lo = m << e
            hi = (m + 1) << e
        return lo * self.resolution, hi * self.resolution

    # -- hot path -------------------------------------------------------
    def record(self, value: float) -> None:
        v = int(value / self.resolution)
        if v < 0:
            v = 0
        idx = self._index(v)
        c = self.counts
        c[idx] = c.get(idx, 0) + 1
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    # -- read side ------------------------------------------------------
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Element-wise sum into a NEW histogram (inputs untouched).
        Requires equal resolutions; associative and commutative."""
        if other.resolution != self.resolution:
            raise ValueError("histogram resolutions differ: "
                             f"{self.resolution} vs {other.resolution}")
        out = LogHistogram(self.resolution)
        out.counts = dict(self.counts)
        for idx, n in other.counts.items():
            out.counts[idx] = out.counts.get(idx, 0) + n
        out.count = self.count + other.count
        out.total = self.total + other.total
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    def quantile(self, q: float) -> float:
        """Conservative q-quantile: upper bound of the bucket holding
        the ceil(q*count)-th sample. 0.0 when empty."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        target = max(int(q * self.count + 0.999999), 1)
        seen = 0
        for idx in sorted(self.counts):
            seen += self.counts[idx]
            if seen >= target:
                return self._bounds(idx)[1]
        return self._bounds(max(self.counts))[1]

    def snapshot(self) -> Dict[str, object]:
        """JSON-friendly view: sorted ``[lo, hi, n]`` bucket rows plus
        the scalar moments."""
        rows = [[*self._bounds(idx), n]
                for idx, n in sorted(self.counts.items())]
        return {"count": self.count,
                "sum": self.total,
                "min": self.min if self.count else 0.0,
                "max": self.max,
                "resolution": self.resolution,
                "buckets": rows}

    @staticmethod
    def merge_all(hists: List["LogHistogram"]) -> "LogHistogram":
        if not hists:
            return LogHistogram()
        out = hists[0]
        for h in hists[1:]:
            out = out.merge(h)
        return out
