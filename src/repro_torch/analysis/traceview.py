"""Copy of `repro/analysis/traceview.py`.

Export runtime traces to Perfetto / Chrome-trace JSON.

Consumes the event timeline recorded by ``repro_torch.core.trace`` (either a
``TraceRecorder.save`` file or an in-memory event list) and emits the
Trace Event Format that ``ui.perfetto.dev`` and ``chrome://tracing``
load directly:

  * one lane per worker slot (pid 0) with a complete-event ("X") slice
    per task body, colored by scope so tenants are visually separable;
  * instant events ("i") on the owning lane for the pre-execution
    lifecycle (``created`` / ``deps_resolved`` / ``ready``), steals
    (thief lane, victim in args) and admission deferrals;
  * one counter lane per message queue / shard mailbox (pid 1): the
    running backlog rebuilt from ``msg_enqueued`` / ``msg_drained``
    payloads ``(kind, where, n)``, keyed by ``where``;
  * vertical ``quiesce`` markers carrying the replay iteration count,
    so replayed (manager-silent) windows are visible at a glance.

CLI::

    python -m repro_torch.analysis.traceview run.trace [-o out.json] [--detect]
        [--counters metrics.json]

``--detect`` additionally runs the detrimental-pattern detectors and
prints their findings to stderr (exit status stays 0 — detection is
reporting, not a gate). ``--counters`` merges the sampled series of a
saved metrics snapshot (``repro_torch.core.metrics.save_metrics``) as
Perfetto counter tracks under the task slices.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from ..core.trace import (EV_ADMIT_DEFER, EV_COMBINE, EV_CREATED,
                          EV_DELEGATE, EV_DEPS, EV_END, EV_MSG_DRAIN,
                          EV_MSG_ENQ, EV_QUIESCE, EV_READY, EV_START,
                          EV_STEAL, TraceEvent, detect_all, load_trace)

# chrome://tracing reserved color names, cycled per scope (None = the
# driver's own root context gets the first entry)
_SCOPE_COLORS = ("thread_state_running", "thread_state_iowait",
                 "thread_state_runnable", "light_memory_dump",
                 "detailed_memory_dump", "vsync_highlight_color",
                 "generic_work", "good", "bad", "terrible")

_WORKERS_PID = 0
_QUEUES_PID = 1


def _scale(time_unit: str) -> float:
    """Trace Event timestamps are microseconds."""
    return 1e6 if time_unit == "s" else 1.0


def _scope_color(scope) -> str:
    if scope is None:
        return _SCOPE_COLORS[0]
    return _SCOPE_COLORS[1 + hash(scope) % (len(_SCOPE_COLORS) - 1)]


def to_chrome_trace(events: Sequence[TraceEvent],
                    time_unit: str = "s") -> dict:
    """Build the Trace Event Format document (``{"traceEvents": [...]}``)
    from a merged event list. Start/end pairing is by ``wd_id`` (a
    body runs on one slot), so the sim's early-visibility timestamps
    cannot mis-nest slices."""
    k = _scale(time_unit)
    out: List[dict] = []
    slots_seen: set = set()
    queues_seen: set = set()
    open_start: Dict[int, TraceEvent] = {}   # wd_id -> start event
    backlog: Dict[object, int] = {}          # queue key -> depth

    for e in events:
        if e.slot >= 0:
            slots_seen.add(e.slot)
        if e.ev == EV_START:
            open_start[e.wd_id] = e
        elif e.ev == EV_END:
            s = open_start.pop(e.wd_id, None)
            if s is None:
                continue                     # start dropped by the ring
            out.append({"name": e.label or f"wd{e.wd_id}", "ph": "X",
                        "pid": _WORKERS_PID, "tid": e.slot,
                        "ts": s.t * k, "dur": max((e.t - s.t) * k, 0.0),
                        "cat": "task", "cname": _scope_color(e.scope),
                        "args": {"wd_id": e.wd_id, "scope": e.scope}})
        elif e.ev in (EV_CREATED, EV_DEPS, EV_READY, EV_STEAL,
                      EV_ADMIT_DEFER):
            args = {"wd_id": e.wd_id, "scope": e.scope}
            if e.data is not None:
                args["data"] = e.data
            out.append({"name": e.ev, "ph": "i", "s": "t",
                        "pid": _WORKERS_PID,
                        "tid": e.slot if e.slot >= 0 else 0,
                        "ts": e.t * k, "cat": "lifecycle", "args": args})
        elif e.ev in (EV_MSG_ENQ, EV_MSG_DRAIN, EV_DELEGATE):
            # delegated publications are backlog like mailbox entries;
            # the combiner's per-message msg_drained events balance them
            d = e.data
            if isinstance(d, (tuple, list)) and len(d) >= 3:
                key, n = d[1], int(d[2])
            else:
                key, n = -1, 1
            backlog[key] = backlog.get(key, 0) \
                + (-n if e.ev == EV_MSG_DRAIN else n)
            queues_seen.add(key)
            out.append({"name": f"mailbox {key}", "ph": "C",
                        "pid": _QUEUES_PID, "tid": 0, "ts": e.t * k,
                        "args": {"backlog": max(backlog[key], 0)}})
        elif e.ev == EV_COMBINE:
            d = e.data
            n = int(d[2]) if isinstance(d, (tuple, list)) \
                and len(d) >= 3 else 1
            out.append({"name": "combine", "ph": "i", "s": "t",
                        "pid": _QUEUES_PID, "tid": 0, "ts": e.t * k,
                        "cat": "sync", "args": {"portions": n}})
        elif e.ev == EV_QUIESCE:
            args = dict(e.data) if isinstance(e.data, dict) else {}
            out.append({"name": "quiesce", "ph": "i", "s": "g",
                        "pid": _WORKERS_PID, "tid": 0, "ts": e.t * k,
                        "cat": "boundary", "args": args})

    meta: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": _WORKERS_PID,
         "args": {"name": "workers"}},
        {"name": "process_name", "ph": "M", "pid": _QUEUES_PID,
         "args": {"name": "queues"}},
    ]
    for s in sorted(slots_seen):
        meta.append({"name": "thread_name", "ph": "M",
                     "pid": _WORKERS_PID, "tid": s,
                     "args": {"name": f"worker {s}"}})
    return {"traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {"time_unit": time_unit,
                          "queues": sorted(queues_seen, key=str)}}


def export(trace_path: str, out_path: Optional[str] = None,
           detect: bool = False,
           counters: Optional[str] = None) -> str:
    """Convert a saved trace file; returns the output path.
    ``counters=`` merges the sampled series of a saved metrics
    snapshot (``core.metrics.save_metrics``) as Perfetto counter
    ("C") tracks on their own pid, under the task slices."""
    events, meta = load_trace(trace_path)
    doc = to_chrome_trace(events, meta.get("time_unit") or "s")
    if counters:
        from ..core.metrics import counter_track_events, load_metrics
        snap = load_metrics(counters)
        series = (snap.get("sampler") or {}).get("series") or {}
        doc["traceEvents"] += counter_track_events(
            series, snap.get("time_unit") or meta.get("time_unit")
            or "s")
    out_path = out_path or trace_path + ".json"
    with open(out_path, "w") as f:
        json.dump(doc, f)
    if detect:
        for fd in detect_all(events):
            print(f"{fd.kind}: [{fd.t0:.6g}, {fd.t1:.6g}] slot={fd.slot} "
                  f"count={fd.count} {fd.detail}", file=sys.stderr)
    return out_path


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Export a repro runtime trace to Perfetto/Chrome "
                    "trace JSON")
    ap.add_argument("trace", help="file written by TraceRecorder.save")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <trace>.json)")
    ap.add_argument("--detect", action="store_true",
                    help="also run the detrimental-pattern detectors "
                         "and print findings to stderr")
    ap.add_argument("--counters", default=None, metavar="METRICS_JSON",
                    help="merge a saved metrics snapshot's sampled "
                         "series as counter tracks")
    args = ap.parse_args(argv)
    out = export(args.trace, args.out, detect=args.detect,
                 counters=args.counters)
    print(out)
    return 0


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(main())
