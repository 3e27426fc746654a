"""Fault-tolerant checkpointing; counterpart of `repro/train/checkpoint.py`
with the same on-disk layout.

* double-buffered: writes go to `<dir>/tmp-<step>`, then atomic rename to
  `<dir>/step-<step>`; the previous checkpoint survives any crash.
* asynchronous: `save()` copies the tree's tensors to host memory (a copy,
  so later in-place updates of the parameters cannot reach it) and
  enqueues the write; the disk I/O runs in idle host time through the
  Functionality Dispatcher, or synchronously via `flush()`.
* integrity: every leaf gets a crc; a manifest with the leaf paths,
  shapes and step is written LAST so a torn write is detectable.
* restore: newest complete+valid checkpoint wins; torn/corrupt ones are
  skipped — together with the data pipeline's determinism this gives
  exact resume.

A tree is nested dicts of tensors (here `{"params": state_dict, "opt":
{"m": ..., "v": ..., "step": ...}}`), flattened in sorted key order.
bf16 leaves are stored as uint16 and viewed back as `torch.bfloat16`, so
no numpy bf16 type is needed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dispatcher import FunctionalityDispatcher


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(like: Any, leaves: Dict[str, torch.Tensor],
               prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str,
                 dispatcher: Optional[FunctionalityDispatcher] = None,
                 keep: int = 2):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: list = []
        self._lock = threading.Lock()
        self.async_writes = 0
        self.last_write: Dict[str, Any] = {}    # step, bytes, seconds
        if dispatcher is not None:
            dispatcher.register("ckpt-flush", self._callback, priority=1)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        host = [(path, _to_numpy(t), str(t.dtype).replace("torch.", ""))
                for path, t in _flatten(tree)]     # device -> host snapshot
        with self._lock:
            self._pending.append((step, host))
        if blocking:
            self.flush()

    def _callback(self, worker_id: int) -> None:
        del worker_id
        self.flush(limit=1)

    def flush(self, limit: Optional[int] = None) -> int:
        done = 0
        while True:
            with self._lock:
                if not self._pending or (limit is not None and done >= limit):
                    return done
                step, host = self._pending.pop(0)
            self._write(step, host)
            done += 1

    def _write(self, step: int, host: list) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"tmp-{step}")
        final = os.path.join(self.dir, f"step-{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        nbytes = 0
        for i, (path, arr, dtype) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf{i}.npy"), arr)
            nbytes += arr.nbytes
            manifest["leaves"].append({
                "i": i, "path": path, "shape": list(arr.shape),
                "dtype": dtype,
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self.async_writes += 1
        self.last_write = {"step": step, "bytes": nbytes,
                           "seconds": time.perf_counter() - t0}
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                out.append(int(name.split("-", 1)[1]))
        return sorted(out)

    def restore(self, like: Any) -> Optional[Tuple[int, Any]]:
        """Restore into the structure of `like` from the newest VALID
        checkpoint, each leaf on its `like` leaf's device. Returns (step,
        tree) or None."""
        flat_like = _flatten(like)
        for step in sorted(self.steps(), reverse=True):
            d = os.path.join(self.dir, f"step-{step}")
            try:
                with open(os.path.join(d, "manifest.json")) as f:
                    manifest = json.load(f)
                assert len(manifest["leaves"]) == len(flat_like)
                leaves = {}
                for ent, (path, ref) in zip(manifest["leaves"], flat_like):
                    arr = np.load(os.path.join(d, f"leaf{ent['i']}.npy"))
                    if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                            != ent["crc"]:
                        raise ValueError("crc mismatch")
                    if ent["dtype"] == "bfloat16":
                        t = torch.from_numpy(arr.view(np.int16)).view(
                            torch.bfloat16)
                    else:
                        t = torch.from_numpy(arr)
                    assert ent["path"] == path
                    assert tuple(t.shape) == tuple(ref.shape)
                    assert t.dtype == ref.dtype
                    leaves[path] = t.to(ref.device)
                return step, _unflatten(like, leaves)
            except Exception:  # torn/corrupt -> try older  # noqa: BLE001
                continue
        return None
