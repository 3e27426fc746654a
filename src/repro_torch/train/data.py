"""Data pipeline, copy of `repro/train/data.py`: deterministic synthetic
LM batches (numpy) + a prefetcher that runs through the Functionality
Dispatcher — idle host threads fill the prefetch queue exactly the way
idle workers drain DDAST queues (the paper's idle-resource philosophy
applied to the framework's own I/O)."""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from ..core.dispatcher import FunctionalityDispatcher
from ..models.config import ModelConfig


@dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    prefetch_depth: int = 4


class SyntheticLM:
    """Deterministic synthetic corpus: Zipf-ish token draws with a simple
    Markov structure so the loss actually decreases during training."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg
        v = cfg.vocab_size
        rng = np.random.RandomState(dcfg.seed)
        probs = 1.0 / np.arange(1, min(v, 4096) + 1) ** 1.1
        self._probs = probs / probs.sum()
        self._shift = rng.randint(1, min(v, 4096))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.dcfg.seed + 7919 * step)
        b, s = self.dcfg.batch, self.dcfg.seq_len
        base = rng.choice(len(self._probs), size=(b, s), p=self._probs)
        # Markov structure: next token correlated with current
        tok = base.copy()
        tok[:, 1::2] = (tok[:, 0::2][:, :tok[:, 1::2].shape[1]]
                        + self._shift) % min(self.cfg.vocab_size, 4096)
        labels = np.roll(tok, -1, axis=1)
        return {"tokens": tok.astype(np.int32),
                "labels": labels.astype(np.int32)}


class Prefetcher:
    """Registered as a dispatcher callback: whenever a host thread is idle
    it tops up the prefetch deque. `get(step)` blocks only if the pipeline
    is behind (and then fills synchronously — never deadlocks)."""

    def __init__(self, dataset: SyntheticLM,
                 dispatcher: Optional[FunctionalityDispatcher] = None,
                 depth: int = 4):
        self.ds = dataset
        self.depth = depth
        self._buf: deque = deque()
        self._next = 0
        self._lock = threading.Lock()
        self.fills_async = 0
        self.fills_sync = 0
        if dispatcher is not None:
            dispatcher.register("data-prefetch", self._callback, priority=5)

    def _callback(self, worker_id: int) -> None:
        del worker_id
        while True:
            with self._lock:
                if len(self._buf) >= self.depth:
                    return
                step = self._next
                self._next += 1
            batch = self.ds.batch_at(step)
            with self._lock:
                self._buf.append((step, batch))
                self.fills_async += 1

    def get(self, step: int) -> Dict[str, np.ndarray]:
        with self._lock:
            while self._buf:
                s, b = self._buf.popleft()
                if s == step:
                    return b
                # stale entries (after restore/rewind): drop
        self.fills_sync += 1
        with self._lock:
            self._next = max(self._next, step + 1)
        return self.ds.batch_at(step)
