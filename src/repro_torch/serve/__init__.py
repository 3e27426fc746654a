"""Serving: batched decode steps and the continuous-batching engine."""
