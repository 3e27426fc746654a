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

With ``runtime=`` (a multi-tenant ``TaskRuntime(num_clients>=1)`` of
`repro_torch.core`) each client queue becomes a
:class:`~repro_torch.core.scopes.JobScope` on the real runtime instead of
the engine's private drain loop: every drained request is submitted as a
scope task chained per client (region ``("reqchain",)`` INOUT under the
scope's namespace: client FIFO for free), the scopes' weighted-fair
admission decides which client's requests reach the admission buffer
first, and per-client ``max_inflight`` bounds a flooding client's
presence in the shared pool. Scope task bodies only append to that
buffer; every device call stays on the thread that steps the engine.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

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
                 runtime: Any = None,
                 client_weights: Optional[Sequence[float]] = None,
                 client_max_inflight: Optional[Sequence[Optional[int]]]
                 = None,
                 client_deadlines: Optional[Sequence[Optional[float]]]
                 = None):
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.ddast = ddast or DDASTParams()
        self.client_queues = [WorkerQueues(i) for i in range(num_clients)]
        self._req_ids = itertools.count()
        # runtime-backed request layer: one JobScope per client queue
        self.runtime = runtime
        self._scopes: List[Any] = []
        self._admitq: deque = deque()   # GIL-atomic: filled by scope
        #   task bodies on worker threads, drained by the engine step
        if runtime is not None:
            ws = (list(client_weights) if client_weights is not None
                  else [1.0] * num_clients)
            caps = (list(client_max_inflight)
                    if client_max_inflight is not None
                    else [None] * num_clients)
            dls = (list(client_deadlines)
                   if client_deadlines is not None
                   else [None] * num_clients)
            if len(ws) != num_clients or len(caps) != num_clients \
                    or len(dls) != num_clients:
                raise ValueError("client_weights/client_max_inflight/"
                                 "client_deadlines must have "
                                 "num_clients entries")
            for c in range(num_clients):
                # deadline= makes the client scope an SLO tenant: the
                # scope records per-task met/missed + slack (exported by
                # metrics_snapshot) and hard-expires past the deadline
                self._scopes.append(runtime.open_scope(
                    f"client{c}", weight=ws[c], max_inflight=caps[c],
                    deadline=dls[c]))
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

    def _pump_to_scopes(self) -> None:
        """Runtime-backed request layer: move drained client-queue entries
        onto the runtime as per-client scope tasks. The per-client
        ``("reqchain",) INOUT`` chain (scope-qualified by the keying shim,
        so clients never alias) keeps each client FIFO; which client's
        chain advances first is the scope layer's weighted-fair admission.
        Task bodies append to the GIL-atomic admission buffer the engine
        step admits from.

        The pumping thread first claims its own runtime submit slot: scope
        submissions ride per-thread SPSC queues, so a serving thread that
        differs from the engine's constructing thread must not share the
        main slot with a concurrently-submitting main thread (size
        ``num_clients`` one larger when stepping from a dedicated
        thread)."""
        self.runtime._ensure_client_slot()
        for cid, q in enumerate(self.client_queues):
            if not q.acquire_submit():
                continue
            try:
                while True:
                    req = q.submit.pop()
                    if req is None:
                        break
                    self._scopes[cid].task(
                        self._admitq.append, req,
                        deps=[(("reqchain",), "inout")],
                        label=f"req{req.req_id}")
                    self.stats["drained_msgs"] += 1
            finally:
                q.release_submit()

    def scope_admission(self) -> Dict[str, dict]:
        """Per-client fairness counters from the runtime's admission
        layer (runtime-backed engines only)."""
        return {sc.name:
                self.runtime.placement.scope_admission(sc.scope_id)
                for sc in self._scopes}

    def _admit_requests(self) -> None:
        """DDAST callback port: round-robin client queues, up to
        MAX_OPS_THREAD per queue, stopping once the free slots are filled.
        Each drain pass admits its batch longest-remaining-chain first.

        Runtime-backed engines skip the private drain discipline: the
        scope layer already ordered requests into the admission buffer;
        this just fills free slots from it."""
        if self.runtime is not None:
            self._pump_to_scopes()
            batch: List[Request] = []
            while self._free_slots() - len(batch) > 0:
                try:
                    batch.append(self._admitq.popleft())
                except IndexError:
                    break
            for req in self._admission_order(batch):
                self._admit(req)
            return
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
        """Requests not yet in a batch slot: client queues, plus (when
        runtime-backed) in-flight scope tasks and the admission buffer."""
        n = sum(len(q.submit) for q in self.client_queues)
        n += len(self._admitq)
        for sc in self._scopes:
            n += sc.root.num_children_alive
        return n

    # ----------------------------------------------------- observability
    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-friendly serving metrics: engine gauges plus one entry per
        client: its request-latency histogram (in engine steps) and, for
        runtime-backed engines, the scope layer's admission counters and
        SLO attainment (``client_deadlines=``)."""
        clients: Dict[str, Any] = {}
        for cid in range(len(self.client_queues)):
            entry: Dict[str, Any] = {}
            hist = self._client_latency[cid]
            if hist.count:
                entry["latency_steps"] = hist.snapshot()
            if self._scopes:
                sc = self._scopes[cid]
                entry["admission"] = \
                    self.runtime.placement.scope_admission(sc.scope_id)
                slo = sc.slo_snapshot()
                if slo is not None:
                    entry["slo"] = slo
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

    def serve_metrics(self, port: int = 0):
        """Start a Prometheus scrape endpoint (text format 0.0.4) on
        localhost in a daemon thread; ``port=0`` picks a free port.
        Returns ``(server, port)``: call ``server.shutdown()`` when done.
        Every GET /metrics renders a fresh snapshot, so scrapes observe
        the run in flight."""
        import http.server
        engine = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API name)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = engine.metrics_text().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass                   # scrapes must not spam stderr

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                              _Handler)
        threading.Thread(target=srv.serve_forever,
                         name="metrics-scrape", daemon=True).start()
        return srv, srv.server_address[1]

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
