"""Viewers for the port's runtime traces and metrics snapshots (copies of
`repro/analysis/traceview.py` and `repro/analysis/metricsview.py`)."""
