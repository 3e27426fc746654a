"""The program's own spans in a profiled window, and the device operations
each one launched.

`devtrace.reduce_events` names time by the harness's `pb.*` spans and
kernels by name. The program also marks its layers (`port.<layer>.<what>`
ranges from `repro_torch.core.trace.span`, recorded while a profiler
runs). `reduce(events)` reads the same Chrome trace for them:

- each device operation keeps the host time of its launch, the
  `cuda_runtime` or `cuda_driver` event with the same `args.correlation`,
  so an operation belongs to the spans open at its launch on any thread
  (the backward's launches come from the autograd engine's thread while
  the stepping thread sits in `port.train.backward`);
- an idle gap is named by the innermost span at its middle among the
  `pb.*` spans and the `port.*` spans of the threads that launched at
  least one device operation in the window (so a worker's spans never
  name the card's idle time).

The window, the operations, `busy_s` and the gaps' bounds are
`devtrace`'s, so `ProgramTrace.profile` reads as a `devtrace.Profile`
with finer gap names. The readers at the end are those of the per-layer
metrics on the program's spans and counters; each returns None where the
record holds nothing of them.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import devtrace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PROGRAM = "port."
OPTIMIZER = ("port.train.clip", "port.train.adamw")
STEP_PHASES = ("port.train.forward", "port.train.backward") + OPTIMIZER
MOE = ("port.moe.route", "port.moe.dispatch", "port.moe.combine")

Span = Tuple[str, tuple, float, float]        # name, (pid, tid), µs, µs


@dataclass
class ProgramTrace:
    profile: devtrace.Profile       # gaps named with the program's spans
    launches: List[Optional[float]]  # each of profile.ops: its launch, µs
    spans: List[Span]               # the pb.* and port.* spans
    gaps: List[Tuple[str, float, float]]    # (name, start µs, end µs)


def _x(e: dict) -> Tuple[float, float]:
    a = float(e["ts"])
    return a, a + float(e.get("dur", 0.0))


def reduce(events: List[dict]) -> ProgramTrace:
    """The Chrome trace's events (times in µs) reduced to a
    `ProgramTrace`."""
    wins = [e for e in events if e.get("name") == devtrace.WINDOW
            and e.get("cat") == "user_annotation"]
    if len(wins) != 1:
        raise RuntimeError(f"{len(wins)} '{devtrace.WINDOW}' spans in the "
                           f"trace")
    w0, w1 = _x(wins[0])
    ops, spans, launch = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        if cat in devtrace.DEVICE_CATS:
            a, b = _x(e)
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ops.append((name, a, b, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                t = float(e["ts"])
                old = launch.get(corr)
                if old is None or t < old[0]:   # the outermost call
                    launch[corr] = (t, (e.get("pid"), e.get("tid")))
        elif cat == "user_annotation" and name != devtrace.WINDOW and \
                name.startswith(("pb.", PROGRAM)):
            spans.append((name, (e.get("pid"), e.get("tid")), *_x(e)))
    at = [launch.get(c) for _, _, _, c in ops]
    launchers = {x[1] for x in at if x is not None}
    namers = [s for s in spans if s[0].startswith("pb.") or s[1] in launchers]
    busy = devtrace._union([(a, b) for _, a, b, _ in ops])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            mid = (t + a) / 2
            inner = [s for s in namers if s[2] <= mid <= s[3]]
            name = (min(inner, key=lambda s: s[3] - s[2])[0] if inner
                    else "between calls")
            gaps.append((name, t, a))
        t = max(t, b)
    prof = devtrace.Profile(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        ops=[(n, (b - a) * 1e-6) for n, a, b, _ in ops],
        gaps=[(n, (b - a) * 1e-6) for n, a, b in gaps])
    return ProgramTrace(profile=prof,
                        launches=[None if x is None else x[0] for x in at],
                        spans=spans, gaps=gaps)


def intervals(pt: ProgramTrace, names: Sequence[str]
              ) -> List[Tuple[float, float]]:
    """The union of the intervals of the spans named `names`, any thread."""
    return devtrace._union([(a, b) for n, _, a, b in pt.spans if n in names])


def _inside(iv: List[Tuple[float, float]], t: float) -> bool:
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return i >= 0 and iv[i][0] <= t <= iv[i][1]


def launched_in(pt: ProgramTrace, names: Sequence[str]) -> Tuple[float, int]:
    """Device seconds and count of the operations launched while one of
    the spans `names` was open."""
    iv = intervals(pt, names)
    s, n = 0.0, 0
    for (_, secs), t in zip(pt.profile.ops, pt.launches):
        if t is not None and _inside(iv, t):
            s, n = s + secs, n + 1
    return s, n


def host_seconds(pt: ProgramTrace, names: Sequence[str]) -> float:
    """Host seconds inside the spans `names` (their union)."""
    return sum(b - a for a, b in intervals(pt, names)) * 1e-6


def idle_owners(pt: ProgramTrace, within: str) -> Dict[str, float]:
    """Idle seconds of the gaps whose middle falls inside a `within` span,
    by the name that each gap took."""
    iv = intervals(pt, (within,))
    out: Dict[str, float] = {}
    for name, a, b in pt.gaps:
        if _inside(iv, (a + b) / 2):
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def profiled(fn: Callable[[], None]) -> List[dict]:
    """`devtrace.profiled`'s window around `fn`, its Chrome trace's events
    returned unreduced."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


# ------------------------------------------------------------------ readers
# the record's "program_trace" (a ProgramTrace over `profiled_units` steps
# or calls) and "counters" (differences over the window: "step_clock"
# [calls, wall s, CPU s], "idle_polls")

def _spanned(rec, names, device: bool = False) -> Optional[ProgramTrace]:
    """The record's trace if it holds one of the spans `names` (and, for
    a device reading, any device operation at all)."""
    pt = rec.get("program_trace")
    if pt is None or not any(n in names for n, _, _, _ in pt.spans) or \
            (device and not pt.profile.ops):
        return None
    return pt


def launched_ms(rec, names) -> Optional[float]:
    """Device ms a unit of the operations launched inside `names`."""
    pt = _spanned(rec, names, device=True)
    if pt is None:
        return None
    return 1e3 * launched_in(pt, names)[0] / rec["profiled_units"]


def launches(rec, names) -> Optional[float]:
    """Device operations a unit launched inside `names`."""
    pt = _spanned(rec, names, device=True)
    if pt is None:
        return None
    return launched_in(pt, names)[1] / rec["profiled_units"]


def host_ms(rec, names) -> Optional[float]:
    """Host ms a unit inside `names`."""
    pt = _spanned(rec, names)
    if pt is None:
        return None
    return 1e3 * host_seconds(pt, names) / rec["profiled_units"]


def offcpu_pct(rec) -> Optional[float]:
    """100 x (1 - CPU s / wall s) of the step clock over the window."""
    clock = rec.get("counters", {}).get("step_clock")
    if not clock or clock[1] <= 0:
        return None
    return 100.0 * (1.0 - clock[2] / clock[1])


def idle_polls_per_step(rec) -> Optional[float]:
    """The runtime workers' idle polls over the window, a step."""
    polls = rec.get("counters", {}).get("idle_polls")
    steps = rec.get("window", {}).get("steps")
    if polls is None or not steps:
        return None
    return polls / steps
