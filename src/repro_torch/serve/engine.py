"""Continuous-batching serving engine with the paper's asynchronous
organization at the request layer; counterpart of `repro/serve/engine.py`.

Clients never touch the engine's scheduling structures: `submit()` pushes
a request into the calling client's own SPSC queue (core.queues). The
engine loop plays the DDAST manager: it drains client queues round-robin,
up to MAX_OPS_THREAD per client, stopping once the free slots are filled,
admits requests into batch slots, and every engine step advances all
active slots by one token with a single batched `decode_step` (prompt
tokens are teacher-forced through the decode path; generated tokens
continue it). Slots free as requests finish: continuous batching with
per-slot positions.

The JAX engine's ``runtime=`` mode (client queues as JobScopes on a
TaskRuntime) and its HTTP scrape endpoint wait for the port of the
runtime; ``runtime=`` raises here.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.ddast import DDASTParams
from ..core.metrics import LogHistogram, prometheus_text
from ..core.queues import WorkerQueues
from ..core.sched import DagNode, bottom_levels, build_arrays
from ..models.registry import ModelAPI
from .serve_step import make_serve_step


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    # stamped by the owning engine at submit time (per-engine counter)
    req_id: Optional[int] = None
    # which client queue carried this request (-1 = never submitted)
    client_id: int = -1
    output: List[int] = field(default_factory=list)
    done_event: threading.Event = field(default_factory=threading.Event)
    admitted_step: int = -1
    finished_step: int = -1


@dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                    # next cache position
    prompt_left: int = 0

    @property
    def free(self) -> bool:
        return self.req is None


class ServeEngine:
    def __init__(self, model: ModelAPI, params: Any, *, batch_slots: int = 4,
                 max_len: int = 256, num_clients: int = 4,
                 ddast: Optional[DDASTParams] = None, eos_id: int = -1,
                 runtime: Any = None):
        if runtime is not None:
            raise NotImplementedError(
                "ServeEngine(runtime=) needs the TaskRuntime port")
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.ddast = ddast or DDASTParams()
        self.client_queues = [WorkerQueues(i) for i in range(num_clients)]
        self._req_ids = itertools.count()
        self.slots = [_Slot() for _ in range(self.B)]
        self.cache = model.init_cache(self.B, max_len)
        self._tokens = np.zeros((self.B,), np.int32)
        self._pos = np.zeros((self.B,), np.int32)
        self._step_fn = make_serve_step(model)
        self.steps = 0
        self.completed: List[Request] = []
        # nonfinite_steps: steps whose logits held a NaN or inf in an
        # active slot (a health check; the tokens alone would hide it)
        self.stats = {"admitted": 0, "drained_msgs": 0, "callback_passes": 0,
                      "nonfinite_steps": 0}
        # per-client admitted->finished latency in engine steps, recorded
        # only on the engine-step thread
        self._client_latency = [LogHistogram(1.0)
                                for _ in range(num_clients)]

    # ------------------------------------------------------- client API
    def submit(self, req: Request, client_id: int = 0) -> Request:
        """Lock-free from the caller's perspective: single-producer push
        into the client's own queue (the Submit Task Message analogue)."""
        if req.req_id is None:
            req.req_id = next(self._req_ids)
        req.client_id = client_id
        self.client_queues[client_id].submit.push(req)
        return req

    # ---------------------------------------------------- manager logic
    def _free_slots(self) -> int:
        return sum(1 for s in self.slots if s.free)

    def _admit_requests(self) -> None:
        """DDAST callback port: round-robin client queues, up to
        MAX_OPS_THREAD per queue, stopping once the free slots are filled.
        Each drain pass admits its batch longest-remaining-chain first."""
        p = self.ddast
        self.stats["callback_passes"] += 1
        spins = max(p.max_spins, 1)
        while self._free_slots() > 0 and spins > 0:
            total = 0
            batch: List[Request] = []
            for q in self.client_queues:
                if self._free_slots() - len(batch) == 0:
                    break
                cnt = 0
                if q.acquire_submit():
                    try:
                        while cnt < p.max_ops_thread and \
                                self._free_slots() - len(batch) > 0:
                            req = q.submit.pop()
                            if req is None:
                                break
                            batch.append(req)
                            cnt += 1
                    finally:
                        q.release_submit()
                total += cnt
            for req in self._admission_order(batch):
                self._admit(req)
            self.stats["drained_msgs"] += total
            spins = spins - 1 if total == 0 else spins
            if total == 0:
                break

    @staticmethod
    def _admission_order(batch: List[Request]) -> List[Request]:
        """Order one drain pass's admissions by descending bottom level of
        each request's prefill->decode chain. Stable: equal chains keep
        their FIFO order."""
        if len(batch) < 2:
            return batch
        nodes = []
        for req in batch:
            nodes.append(DagNode(("prefill", req.req_id),
                                 cost=max(len(req.prompt), 1)))
            nodes.append(DagNode(("decode", req.req_id),
                                 cost=max(req.max_new_tokens, 1),
                                 deps=[("prefill", req.req_id)]))
        idx, succs, _ = build_arrays(nodes)
        levels = bottom_levels(succs, [n.cost for n in nodes])
        return sorted(batch, reverse=True,
                      key=lambda r: levels[idx[("prefill", r.req_id)]])

    def _admit(self, req: Request) -> None:
        for i, slot in enumerate(self.slots):
            if slot.free:
                slot.req = req
                slot.pos = 0
                slot.prompt_left = len(req.prompt)
                req.admitted_step = self.steps
                self._tokens[i] = req.prompt[0]
                self._pos[i] = 0
                self._reset_slot_cache(i)
                self.stats["admitted"] += 1
                return
        raise RuntimeError("no free slot")

    def _reset_slot_cache(self, i: int) -> None:
        """Zero slot i's lanes of every layer's k/v cache."""
        for layer in self.cache:
            for c in layer.values():
                c[i].zero_()

    # ----------------------------------------------------------- stepping
    def step(self) -> int:
        """One engine iteration: drain client queues (manager), then one
        batched decode step. Returns number of active slots advanced."""
        self._admit_requests()
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            return 0
        dev = self.model.device
        next_tok, logits, self.cache = self._step_fn(
            self.params, self.cache, torch.from_numpy(self._tokens).to(dev),
            torch.from_numpy(self._pos).to(dev))
        finite = torch.isfinite(logits[active]).all()
        next_tok = next_tok.cpu().numpy()
        if not bool(finite):
            self.stats["nonfinite_steps"] += 1
        self.steps += 1
        for i in active:
            slot = self.slots[i]
            req = slot.req
            slot.pos += 1
            slot.prompt_left -= 1
            if slot.prompt_left > 0:
                self._tokens[i] = req.prompt[slot.pos]      # teacher-force
            else:
                tok = int(next_tok[i])
                req.output.append(tok)
                self._tokens[i] = tok
                if len(req.output) >= req.max_new_tokens or \
                        tok == self.eos_id or slot.pos + 1 >= self.max_len:
                    req.finished_step = self.steps
                    if 0 <= req.client_id < len(self._client_latency):
                        self._client_latency[req.client_id].record(
                            req.finished_step - req.admitted_step)
                    req.done_event.set()
                    self.completed.append(req)
                    slot.req = None
                    continue
            self._pos[i] = slot.pos
        return len(active)

    def _backlog(self) -> int:
        """Requests not yet in a batch slot."""
        return sum(len(q.submit) for q in self.client_queues)

    # ----------------------------------------------------- observability
    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-friendly serving metrics: engine gauges plus one entry per
        client with its request-latency histogram (in engine steps)."""
        clients: Dict[str, Any] = {}
        for cid in range(len(self.client_queues)):
            entry: Dict[str, Any] = {}
            hist = self._client_latency[cid]
            if hist.count:
                entry["latency_steps"] = hist.snapshot()
            clients[f"client{cid}"] = entry
        return {
            "time_unit": "s",
            "gauges": {"steps": self.steps,
                       "admitted": self.stats["admitted"],
                       "backlog": self._backlog(),
                       "free_slots": self._free_slots()},
            "clients": clients,
        }

    def metrics_text(self) -> str:
        return prometheus_text(self.metrics_snapshot())

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        idle = 0
        for _ in range(max_steps):
            n = self.step()
            if n == 0:
                if self._backlog() == 0:
                    idle += 1
                    if idle > 2:
                        return
            else:
                idle = 0
