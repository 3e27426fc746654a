"""Copy of `repro/analysis/metricsview.py`.

Render a saved metrics snapshot for humans and scrapers.

Consumes the JSON written by ``repro_torch.core.metrics.save_metrics`` (or
any ``rt.metrics()`` / ``SimResult.metrics`` /
``ServeEngine.metrics_snapshot()`` dict dumped to disk) and renders it
either as Prometheus text exposition (default — pipe it to a pushgateway
or diff it in CI) or as a Perfetto/Chrome-trace counter-track document
(``--perfetto`` — load it next to a ``traceview`` export, or merge both
with ``traceview --counters``).

CLI::

    python -m repro_torch.analysis.metricsview run.metrics.json [-o out]
        [--perfetto] [--prefix repro]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from ..core.metrics import (counter_track_events, load_metrics,
                            prometheus_text)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a saved repro metrics snapshot as "
                    "Prometheus text or Perfetto counter tracks")
    ap.add_argument("metrics",
                    help="JSON written by core.metrics.save_metrics")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--perfetto", action="store_true",
                    help="emit Chrome-trace counter tracks instead of "
                         "Prometheus text")
    ap.add_argument("--prefix", default="repro",
                    help="Prometheus metric-name prefix")
    args = ap.parse_args(argv)

    snap = load_metrics(args.metrics)
    if args.perfetto:
        series = (snap.get("sampler") or {}).get("series") or {}
        doc = {"traceEvents": counter_track_events(
                   series, snap.get("time_unit") or "s"),
               "displayTimeUnit": "ms"}
        text = json.dumps(doc)
    else:
        text = prometheus_text(snap, prefix=args.prefix)

    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(args.out)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(main())
