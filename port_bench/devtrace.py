"""A profiled sub-window reduced to what the per-layer metrics read.

`span(name)` wraps one of the harness's own calls in a named host span
(`torch.profiler.record_function`, names starting "pb."). `profiled(fn)`
runs `fn` under `torch.profiler` inside the span "pb.window", writes the
Chrome trace into the run's temporary directory, reads it back and
deletes it: the device operations (kernels, copies, sets) with their
start and length, clipped to the window, and the host spans beside
them. Busy time is the union of the device intervals; an idle gap is a
stretch of the window with none, named by the innermost harness span the
host was in at its middle ("between calls" outside them)."""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "pb.window"


@dataclass
class Profile:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float]]                 # (name, seconds) each op
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        out: Dict[str, Tuple[float, int]] = {}
        for name, s in self.ops:
            t, n = out.get(name, (0.0, 0))
            out[name] = (t + s, n + 1)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name; and the
        idle time by what the host was doing: first each span's total
        over all its gaps, then the longest single gaps."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][0])
        totals: Dict[str, Tuple[float, int]] = {}
        for name, s in self.gaps:
            t, n = totals.get(name, (0.0, 0))
            totals[name] = (t + s, n + 1)
        gaps = [[f"all {n} gaps in {name}", t] for name, (t, n) in
                sorted(totals.items(), key=lambda kv: -kv[1][0])]
        gaps += [[f"one gap in {name}", s] for name, s in
                 sorted(self.gaps, key=lambda g: -g[1])]
        return {"device_ops": [[k, v[0]] for k, v in ops[:top]],
                "idle_gaps": gaps[:top]}


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: List[dict]) -> Profile:
    """The Chrome trace's events (times in µs) reduced to a `Profile`."""
    wins = [e for e in events if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if len(wins) != 1:
        raise RuntimeError(f"{len(wins)} '{WINDOW}' spans in the trace")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ops.append((e["name"], a, b))
        elif e.get("cat") == "user_annotation" and \
                e["name"].startswith("pb.") and e["name"] != WINDOW:
            spans.append((e["name"], a, b))
    busy = _union([(a, b) for _, a, b in ops])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            mid = (t + a) / 2
            inner = [s for s in spans if s[1] <= mid <= s[2]]
            name = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                    else "between calls")
            gaps.append((name, (a - t) * 1e-6))
        t = max(t, b)
    return Profile(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   ops=[(n, (b - a) * 1e-6) for n, a, b in ops], gaps=gaps)


def profiled(fn: Callable[[], None]) -> Profile:
    """Run `fn` (which ends in a device synchronise) under the profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events)


span = record_function
