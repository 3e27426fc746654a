"""Latency histogram and Prometheus export for the serving engine."""
from .export import prometheus_text
from .instruments import LogHistogram

__all__ = ["LogHistogram", "prometheus_text"]
