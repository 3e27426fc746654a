"""Prometheus text exposition (format 0.0.4): copy of `prometheus_text`
from `repro/core/metrics/export.py`.

It renders the JSON-friendly snapshots of ``ServeEngine.metrics_snapshot``
(and the runtime's, once ported): counters get a ``_total`` suffix with
``{slot="i"}`` labels, log-bucket histograms are flattened to cumulative
``_bucket{le="..."}`` rows plus ``_sum`` / ``_count``, per-scope series
carry a ``scope`` label, per-client ones a ``client`` label.
"""
from __future__ import annotations

import re
from typing import Dict, List

__all__ = ["prometheus_text"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _san(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _fmt(v) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _hist_lines(name: str, hist: Dict[str, object],
                labels: str = "") -> List[str]:
    """Flatten a LogHistogram snapshot to cumulative le-buckets."""
    base = labels[:-1] + "," if labels else "{"
    out = [f"# TYPE {name} histogram"]
    cum = 0
    for lo, hi, n in hist.get("buckets", []):
        cum += n
        out.append(f'{name}_bucket{base}le="{_fmt(hi)}"}} {cum}')
    out.append(f'{name}_bucket{base}le="+Inf"}} {hist.get("count", 0)}')
    out.append(f"{name}_sum{labels} {_fmt(hist.get('sum', 0.0))}")
    out.append(f"{name}_count{labels} {hist.get('count', 0)}")
    return out


def prometheus_text(snapshot: Dict[str, object],
                    prefix: str = "repro") -> str:
    """Render any runtime/sim/serve metrics snapshot. Tolerant: only
    sections that are present are emitted."""
    L: List[str] = []
    unit = "us" if snapshot.get("time_unit") == "us" else "seconds"

    for cname, c in (snapshot.get("counters") or {}).items():
        mname = f"{prefix}_{_san(cname)}_total"
        L.append(f"# TYPE {mname} counter")
        if isinstance(c, dict) and "per_slot" in c:
            for i, v in enumerate(c["per_slot"]):
                L.append(f'{mname}{{slot="{i}"}} {_fmt(v)}')
        else:
            tot = c.get("total", c) if isinstance(c, dict) else c
            L.append(f"{mname} {_fmt(tot)}")

    for gname, g in (snapshot.get("gauges") or {}).items():
        mname = f"{prefix}_{_san(gname)}"
        L.append(f"# TYPE {mname} gauge")
        if isinstance(g, dict):
            for k, v in g.items():
                L.append(f'{mname}{{key="{_san(str(k))}"}} {_fmt(v)}')
        else:
            L.append(f"{mname} {_fmt(g)}")

    lat = snapshot.get("task_latency")
    if lat and lat.get("count", 0) >= 0:
        L += _hist_lines(f"{prefix}_task_latency_{unit}", lat)

    for sname, entry in (snapshot.get("scopes") or {}).items():
        lab = f'{{scope="{_san(str(sname))}"}}'
        for k in ("inflight", "tasks_alive"):
            if k in entry:
                L.append(f"{prefix}_scope_{k}{lab} {_fmt(entry[k])}")
        adm = entry.get("admission") or {}
        for k in ("admitted", "admission_waits", "drained",
                  "contended_grants"):
            if k in adm:
                L.append(f"{prefix}_scope_{k}_total{lab} {_fmt(adm[k])}")
        slo = entry.get("slo")
        if slo:
            L.append(f"{prefix}_scope_slo_met_total{lab} "
                     f"{_fmt(slo['met'])}")
            L.append(f"{prefix}_scope_slo_missed_total{lab} "
                     f"{_fmt(slo['missed'])}")
            att = slo.get("attainment")
            if att is not None:
                L.append(f"{prefix}_scope_slo_attainment{lab} "
                         f"{_fmt(att)}")
            if slo.get("slack"):
                L += _hist_lines(f"{prefix}_scope_slack_{unit}",
                                 slo["slack"], lab)

    for cname, entry in (snapshot.get("clients") or {}).items():
        lab = f'{{client="{_san(str(cname))}"}}'
        if entry.get("latency_steps"):
            L += _hist_lines(f"{prefix}_request_latency_steps",
                             entry["latency_steps"], lab)
        adm = entry.get("admission") or {}
        for k in ("admitted", "admission_waits", "drained"):
            if k in adm:
                L.append(f"{prefix}_client_{k}_total{lab} "
                         f"{_fmt(adm[k])}")
        slo = entry.get("slo")
        if slo:
            att = slo.get("attainment")
            if att is not None:
                L.append(f"{prefix}_client_slo_attainment{lab} "
                         f"{_fmt(att)}")
            L.append(f"{prefix}_client_slo_met_total{lab} "
                     f"{_fmt(slo['met'])}")
            L.append(f"{prefix}_client_slo_missed_total{lab} "
                     f"{_fmt(slo['missed'])}")

    workers = snapshot.get("workers") or {}
    if workers.get("totals"):
        for k, v in workers["totals"].items():
            L.append(f"# TYPE {prefix}_worker_{_san(k)} counter")
            L.append(f"{prefix}_worker_{_san(k)} {_fmt(v)}")
        for i, row in enumerate(workers.get("per_worker", [])):
            for k, v in row.items():
                L.append(f'{prefix}_worker_{_san(k)}_slot'
                         f'{{worker="{i}"}} {_fmt(v)}')

    samp = snapshot.get("sampler") or {}
    series = samp.get("series") or {}
    if series:
        mname = f"{prefix}_sampled"
        L.append(f"# TYPE {mname} gauge")
        for sname in sorted(series):
            pts = series[sname]
            if pts:
                L.append(f'{mname}{{series="{_san(sname)}"}} '
                         f"{_fmt(pts[-1][1])}")
    if "samples" in samp:
        L.append(f"{prefix}_sampler_samples_total {samp['samples']}")

    return "\n".join(L) + "\n"
