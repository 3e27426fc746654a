"""Copy of `repro/core/procs/driver.py`, with the changes CUDA needs.

``ProcessRuntime`` — the ``backend="processes"`` driver.

Under CPython threads the GIL serializes task *bodies*, so the threaded
driver can only ever demonstrate the paper's lock-wait story, never real
parallel throughput. This driver keeps the entire dependence-management
stack exactly where the engine refactor put it — the same
``SyncPolicy`` / ``DdastPolicy`` / ``ShardedPolicy`` objects, unchanged —
and moves only the task *bodies* into worker processes:

    main thread (slot 1)        submits; taskwait drains managers
    reaper thread (slot 0)      consumes Done rings, runs idle-manager
                                callbacks (the DDAST discipline: a
                                thread with nothing else to do drains
                                shard mailboxes)
    worker process i (slot 2+i) pops Submit batches from its exec ring,
                                runs bodies, ships Done batches back

Cross-process traffic reuses the §3.1 message shapes in compact binary
wire form (``core.messages.encode_submit_batch`` / ``encode_done_batch``)
over ``multiprocessing.shared_memory`` SPSC rings (``procs.rings``), one
exec + one done ring per worker, with a ``SimpleQueue`` fallback lane
for oversize frames. Dependence analysis itself stays in the parent:
the shard graphs hold live WorkDescriptor references and per-slot
AtomicCounters that cannot cross an address space without a full
shared-heap redesign — README documents this split honestly.

Record-and-replay goes further: once an iteration's structure is frozen
(``engine/replay.py``), the parent builds a **replay plane** — the
frozen ``ReplayGraph``'s flat successor arrays (CSR), per-task latches,
a shared ready ring and the pickled task payloads — in shared memory,
mapped by every worker. A structurally matching iteration then ships
ONE control frame per worker (the latch generation + plane descriptor)
and the workers self-schedule the whole graph: pop sid, run body, dec
successor latches under one shared lock, push newly-ready sids. Zero
Submit/Done mailbox messages cross the process boundary in steady
state — the property ``bench_procs.py`` gates in CI.

Not supported here (documented, enforced): nested tasks (bodies run in
workers and cannot submit), multi-tenant scopes, non-picklable task
functions/args (use ``procs.apps``-style shared-memory data planes; the
fallback lane covers oversize payloads, not unpicklable ones).

What the port changes, because a worker may hold a CUDA context (these
are its only intended differences from the reference):

  (a) Start method: never ``fork`` (a CUDA context does not survive
      one). Workers come from ``forkserver``: the fork server, started
      once per process, preloads ``torch``, this module, ``procs.apps``,
      ``procs.chaos`` and every module of the port the runtime's
      process has loaded, and never initialises CUDA; each
      worker makes its own context on its first CUDA call, or before it
      says it is ready with ``device=``.
  (b) Parent watchdog: a worker's ``os.getppid()`` is the fork server,
      so workers watch ``multiprocessing.parent_process()`` (the
      runtime's process) instead.
  (c) Start-up is never charged to a task: a fresh or respawned worker
      ships one READY frame once its rings, counter row, the modules of
      every task function submitted so far and its device are up;
      ``start()`` waits for every worker's, and a task's ``timeout=``
      counts from the later of its dispatch and its worker's READY.
  (d) A task is done only when its device work is: after a body
      returns, a worker whose CUDA is initialised synchronises its
      device before it stamps ``t1`` and ships the Done entry (live
      path), and before it decrements the successor latches (replay
      plane); the counter plane's ``sync_time_s`` sums those waits.
  (e) Device arrays by name: ``procs.apps.DeviceArray``, attached by
      CUDA IPC handle in the workers (see that module).
  (f) No fallback that hides the card: a worker that cannot use it
      fails its start-up or its body, and the run raises
      :class:`TaskFailed`.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..ddast import DDASTParams
from ..dispatcher import FunctionalityDispatcher
from ..engine import make_policy
from ..engine.replay import RECORDING, REPLAYING
from ..errors import RingCorruption, TaskFailed, WorkerLost
from ..metrics import (NULL_METRICS, MetricsSampler, ShmCounterPlane,
                       WorkerCounterView)
from ..messages import (DONE_ERROR, DONE_NO_RESULT, DONE_OK,
                        DONE_PLANE_ERROR, decode_done_batch,
                        decode_submit_batch, encode_done_batch)
from ..trace import (EV_CREATED, EV_END, EV_READY, EV_RESPAWN, EV_RETRY,
                     EV_START, EV_TIMEOUT_KILL, EV_TRACE_LOST,
                     EV_WORKER_LOST, NULL_TRACER, IncrementalDetector,
                     TraceRecorder, replay_iterations_of)
from ..wd import TaskState, WorkDescriptor
from . import serial
from .chaos import FaultPlan
from .rings import ShmRing
from .serial import (K_CTRL, K_DONE, K_EXEC, K_READY, K_TRACE, OP_ITER,
                     OP_SHUTDOWN, frame_ctrl, frame_exec, frame_ready)

PROC_MODES = ("sync", "dast", "ddast", "sharded")
READY_TIMEOUT_S = 120.0    # a fresh fork server imports torch first

#: modules the fork server imports once, before it forks any worker;
#: ``start()`` adds every module of the port this process has loaded, so
#: that a worker's import of the caller's script (which ``forkserver``,
#: as ``spawn``, runs in each child as ``__mp_main__``) finds them loaded
FORKSERVER_PRELOAD = ["torch", "repro_torch.core.procs.driver",
                      "repro_torch.core.procs.apps",
                      "repro_torch.core.procs.chaos"]


def start_fork_server() -> None:
    """Start this process's fork server, if it is not up, preloading
    FORKSERVER_PRELOAD and the port's loaded modules. ``start()`` calls
    it; a caller may call it earlier, so that the server's preload (it
    imports torch: seconds) runs beside other work. Some Python
    releases (3.12.3 among them) start it on the interpreter's default
    ``sys.path``, not this process's, and it then fails to import the
    port from a source tree and preloads nothing (each worker imported
    torch itself: ~9 s on a card's host); so ``PYTHONPATH`` carries
    ``sys.path`` to it while it starts."""
    from multiprocessing import forkserver
    forkserver.set_forkserver_preload(FORKSERVER_PRELOAD + sorted(
        m for m in sys.modules if m.split(".")[0] == "repro_torch"))
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        os.path.abspath(p) for p in sys.path if p)
    try:
        forkserver.ensure_running()
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old

__all__ = ["ProcessDispatch", "ProcessRuntime", "TaskFailed",
           "WorkerLost", "RingCorruption", "FaultPlan", "PROC_MODES",
           "start_fork_server"]


# ---------------------------------------------------------------------------
# replay plane: shm layout shared by parent and workers
#
#   gen i64 @0 | remaining i32 @8 | ready_head i32 @12 | ready_tail i32
#   @16 | (pad to 32) | ready i32[n] | preds i32[n] | succ_off i32[n+1]
#   | succ_tgt i32[E] | latch i32[n] | exec_slot i32[n] | (pad to 8) |
#   times f64[2n]
#
# All mutation of remaining/ready/latch happens under ONE
# multiprocessing.Lock created before the workers fork; the static
# arrays (preds/succ_*) are written once at freeze and only read after.

_PL_REMAINING = 2          # i32 index (byte 8)
_PL_HEAD = 3               # i32 index (byte 12)
_PL_TAIL = 4               # i32 index (byte 16)
_PL_RING0 = 8              # i32 index (byte 32)


def _plane_offsets(n: int, nedges: int) -> Dict[str, int]:
    off: Dict[str, int] = {}
    b = 32
    off["ready"] = b
    b += 4 * n
    off["preds"] = b
    b += 4 * n
    off["succ_off"] = b
    b += 4 * (n + 1)
    off["succ_tgt"] = b
    b += 4 * nedges
    off["latch"] = b
    b += 4 * n
    off["exec_slot"] = b
    b += 4 * n
    b = (b + 7) & ~7
    off["times"] = b
    off["size"] = b + 16 * n
    return off


class _ReplayImage:
    """Parent-side owner of one frozen graph's replay plane."""

    def __init__(self, g, payload_entries: List[Tuple[bytes, str]]) -> None:
        from multiprocessing import shared_memory
        n = g.n
        nedges = sum(len(s) for s in g.succs)
        off = _plane_offsets(n, nedges)
        self.n = n
        self.g = g
        self.off = off
        self.roots = [sid for sid in range(n) if g.preds[sid] == 0]
        self.labels = [lb for _, lb in payload_entries]
        self.arrays = shared_memory.SharedMemory(create=True,
                                                 size=off["size"])
        self.arrays.buf[:off["size"]] = b"\0" * off["size"]
        blob = pickle.dumps(payload_entries, protocol=4)
        self.payload = shared_memory.SharedMemory(create=True,
                                                  size=len(blob))
        self.payload.buf[:len(blob)] = blob
        ints = self.arrays.buf.cast("i")
        base = off["preds"] // 4
        for sid in range(n):
            ints[base + sid] = g.preds[sid]
        so = off["succ_off"] // 4
        st = off["succ_tgt"] // 4
        k = 0
        for sid in range(n):
            ints[so + sid] = k
            for tgt in g.succs[sid]:
                ints[st + k] = tgt
                k += 1
        ints[so + n] = k
        self.desc = {"arrays": self.arrays.name,
                     "payload": self.payload.name,
                     "payload_size": len(blob),
                     "n": n, "nedges": nedges, "gen": 0}
        self._gen = 0

    def reset(self) -> int:
        """Arm the plane for one iteration; returns the new generation.
        Runs at a quiescent point (remaining==0, no task in flight),
        before the ITER broadcast — but the caller must hold the plane
        lock: a straggler worker can still be inside ``_run_plane``
        (micro-sleeping in its empty-ring branch) and re-read the plane
        mid-reset. Workers only read remaining/head/tail under the same
        lock, so the lock's barriers guarantee they observe either the
        fully-old or fully-new plane — on any memory model, not just
        x86-TSO."""
        ints = self.arrays.buf.cast("i")
        dbls = self.arrays.buf.cast("d")
        off = self.off
        n = self.n
        lat = off["latch"] // 4
        prd = off["preds"] // 4
        exc = off["exec_slot"] // 4
        for sid in range(n):
            ints[lat + sid] = ints[prd + sid]
            ints[exc + sid] = -1
        tm = off["times"] // 8
        for i in range(2 * n):
            dbls[tm + i] = 0.0
        for i, sid in enumerate(self.roots):
            ints[_PL_RING0 + i] = sid
        ints[_PL_HEAD] = 0
        ints[_PL_TAIL] = len(self.roots)
        ints[_PL_REMAINING] = n
        self._gen += 1
        self.arrays.buf.cast("q")[0] = self._gen
        self.desc["gen"] = self._gen
        return self._gen

    def remaining(self) -> int:
        return self.arrays.buf.cast("i")[_PL_REMAINING]

    def times(self, sid: int) -> Tuple[float, float]:
        dbls = self.arrays.buf.cast("d")
        tm = self.off["times"] // 8
        return dbls[tm + 2 * sid], dbls[tm + 2 * sid + 1]

    def exec_slot(self, sid: int) -> int:
        return self.arrays.buf.cast("i")[self.off["exec_slot"] // 4 + sid]

    def unfinished_labels(self) -> List[str]:
        ints = self.arrays.buf.cast("i")
        lat = self.off["latch"] // 4
        del lat
        out = []
        for sid in range(self.n):
            t0, t1 = self.times(sid)
            if t1 == 0.0:
                out.append(self.labels[sid])
        del ints
        return out

    def shm_names(self) -> List[str]:
        return [self.arrays.name, self.payload.name]

    def close_unlink(self) -> None:
        for shm in (self.arrays, self.payload):
            try:
                shm.close()
                shm.unlink()
            except FileNotFoundError:    # pragma: no cover - teardown
                pass


# ---------------------------------------------------------------------------
# worker process side


class _PlaneView:
    """Worker-side attachment to a replay plane (cached per shm name)."""

    def __init__(self, desc: dict) -> None:
        from .rings import attach_shm
        self.arrays = attach_shm(desc["arrays"])
        payload = attach_shm(desc["payload"])
        entries = pickle.loads(bytes(payload.buf[:desc["payload_size"]]))
        payload.close()
        self.payloads = entries          # [(payload_bytes, label)]
        self.tasks: Dict[int, Tuple] = {}  # sid -> (func, args, label)
        self.n = desc["n"]
        off = _plane_offsets(self.n, desc["nedges"])
        ints = self.arrays.buf.cast("i")
        so = off["succ_off"] // 4
        st = off["succ_tgt"] // 4
        # static topology copied to plain lists once: no shm reads on
        # the per-task hot path
        self.succ_off = [ints[so + i] for i in range(self.n + 1)]
        self.succ_tgt = [ints[st + i] for i in range(desc["nedges"])]
        self.latch_i = off["latch"] // 4
        self.exec_i = off["exec_slot"] // 4
        self.times_i = off["times"] // 8
        del ints

    def task(self, sid: int) -> Tuple:
        t = self.tasks.get(sid)
        if t is None:
            payload, label = self.payloads[sid]
            func, args = pickle.loads(payload)
            t = self.tasks[sid] = (func, args, label)
        return t

    def close(self) -> None:
        try:
            self.arrays.close()
        except Exception:                # pragma: no cover - teardown
            pass


def _run_plane(desc: dict, planes: Dict[str, _PlaneView], lock,
               done_ring: ShmRing, clock, slot: int,
               stalls, stall_counts, counters=None) -> None:
    view = planes.get(desc["arrays"])
    if view is None:
        view = planes[desc["arrays"]] = _PlaneView(desc)
    ints = view.arrays.buf.cast("i")
    dbls = view.arrays.buf.cast("d")
    n = view.n
    while True:
        sid = -1
        with lock:
            if ints[_PL_REMAINING] == 0:
                break
            h = ints[_PL_HEAD]
            if h != ints[_PL_TAIL]:
                sid = ints[_PL_RING0 + (h % n)]
                ints[_PL_HEAD] = h + 1
                # claim stamped at POP, under the lock: if this worker
                # dies mid-body the parent's recovery can tell exactly
                # which sid it owed (exec_slot set, end time still 0)
                ints[view.exec_i + sid] = slot
                dbls[view.times_i + 2 * sid] = clock()
        if sid < 0:
            time.sleep(2e-6)
            continue
        func, args, label = view.task(sid)
        if stalls:
            _maybe_stall(stalls, stall_counts, label)
        if counters is not None:
            counters.task_start()
        t0 = clock()
        sync_s = 0.0
        try:
            func(*args)
            # (d) before the latches: a successor in another process
            # must not read a block this body's kernels still write
            sync_s = _sync_device()
        except BaseException:
            done_ring.push(frame_done_one(
                sid, t0, clock(), DONE_PLANE_ERROR,
                traceback.format_exc().encode("utf-8")))
        t1 = clock()
        if counters is not None:
            counters.task_end(t1 - t0, sync_s)
        dbls[view.times_i + 2 * sid] = t0
        dbls[view.times_i + 2 * sid + 1] = t1
        with lock:
            for k in range(view.succ_off[sid], view.succ_off[sid + 1]):
                tgt = view.succ_tgt[k]
                v = ints[view.latch_i + tgt] - 1
                ints[view.latch_i + tgt] = v
                if v == 0:
                    t = ints[_PL_TAIL]
                    ints[_PL_RING0 + (t % n)] = tgt
                    ints[_PL_TAIL] = t + 1
            ints[_PL_REMAINING] -= 1
    del ints, dbls


def _sync_device() -> float:
    """Wait for this worker's device work when a body has initialised
    CUDA here (each worker has its own context and stream, so stream
    order cannot carry a dependence to another process); returns the
    seconds waited."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0.0
    t = time.perf_counter()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _start_device(device: str, matmul_precision: Optional[str]) -> None:
    """Make this worker's CUDA context (``device="cuda"``) before it says
    it is ready, with the runtime's float32 matmul precision."""
    import torch
    if matmul_precision is not None:
        torch.set_float32_matmul_precision(matmul_precision)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)


def frame_done_one(wd_id: int, t0: float, t1: float, status: int,
                   blob: bytes) -> bytes:
    return bytes([K_DONE]) + encode_done_batch(
        [(wd_id, t0, t1, status, blob)])


def _maybe_stall(stalls, counts: Dict[int, int], label: str) -> None:
    """Chaos hook: sleep before a body whose label matches a stall spec
    (per process — a respawned worker starts its counts over)."""
    for i, (substr, stall_s, times) in enumerate(stalls):
        if substr in label and counts.get(i, 0) < times:
            counts[i] = counts.get(i, 0) + 1
            time.sleep(stall_s)


def _worker_main(widx: int, slot: int, exec_name: str, done_name: str,
                 exec_fbq, done_fbq, plane_lock, epoch: float,
                 stalls=(), ignore_sigterm: bool = False,
                 counters_name: str = "", modules=(),
                 device: Optional[str] = None,
                 matmul_precision: Optional[str] = None) -> None:
    t_main = time.perf_counter() - epoch
    if ignore_sigterm:                   # chaos: force the kill path
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    exec_ring = ShmRing.attach(exec_name, fallback=exec_fbq)
    done_ring = ShmRing.attach(done_name, fallback=done_fbq)
    # (b) the runtime's process: under forkserver os.getppid() is the
    # fork server's pid, which outlives any one runtime
    parent = multiprocessing.parent_process()
    # the Done ring's consumer is the parent's reaper thread: keep
    # pushing while the parent process lives
    done_ring.consumer_alive = parent.is_alive
    # live-metrics counter plane (metrics=True): this worker stamps its
    # own row of the parent's shm matrix — single-writer f64 stores, so
    # the parent scrapes task/busy counters with ZERO extra IPC frames
    counters = WorkerCounterView(counters_name, widx) \
        if counters_name else None
    planes: Dict[str, _PlaneView] = {}
    stall_counts: Dict[int, int] = {}

    def clock() -> float:
        # perf_counter is CLOCK_MONOTONIC on Linux: one epoch, every
        # process — worker timestamps merge directly with the parent's
        return time.perf_counter() - epoch

    # (c) start-up: the modules of the tasks submitted so far (a
    # respawned worker is as warm as the one it replaces), then the
    # device; a failure is reported, not hidden, and the worker stays up
    # so that its tasks fail in their bodies
    error = None
    t_dev = t_ready = clock()
    try:
        for mod in modules:
            __import__(mod)
        t_dev = clock()
        if device is not None:
            _start_device(device, matmul_precision)
    except Exception:
        error = traceback.format_exc()
    t_ready = clock()
    done_ring.push(frame_ready({"pid": os.getpid(), "t_main": t_main,
                                "t_device": t_dev, "t": t_ready,
                                "error": error}))

    try:
        idle_checks = 0
        while True:
            try:
                frame = exec_ring.pop()
            except RingCorruption:
                # a corrupt submit cannot be attributed to a task: die
                # quietly (exitcode 3) and let the supervisor respawn
                # this worker and retry/poison its in-flight tasks
                raise SystemExit(3)
            if frame is None:
                time.sleep(2e-5)
                idle_checks += 1
                if idle_checks >= 256:   # orphan watchdog (~5 ms cost)
                    idle_checks = 0
                    if not parent.is_alive():
                        return
                continue
            kind = frame[0]
            if kind == K_EXEC:
                entries = decode_submit_batch(frame, 1)
                dones = []
                for wd_id, payload, label in entries:
                    if stalls:
                        _maybe_stall(stalls, stall_counts, label)
                    if counters is not None:
                        counters.task_start()
                    t0 = clock()
                    status, blob = DONE_OK, b""
                    sync_s = 0.0
                    try:
                        func, args = pickle.loads(payload)
                        res = func(*args)
                        # (d) done means the device work is done too
                        sync_s = _sync_device()
                        if res is not None:
                            try:
                                blob = pickle.dumps(res, protocol=4)
                            except Exception:
                                status = DONE_NO_RESULT
                    except BaseException:
                        status = DONE_ERROR
                        blob = traceback.format_exc().encode("utf-8")
                    t1 = clock()
                    if counters is not None:
                        counters.task_end(t1 - t0, sync_s)
                    dones.append((wd_id, t0, t1, status, blob))
                done_ring.push(bytes([K_DONE]) + encode_done_batch(dones))
            elif kind == K_CTRL:
                op, body = serial.parse(frame)[1]
                if op == OP_SHUTDOWN:
                    return
                if op == OP_ITER:
                    _run_plane(body, planes, plane_lock, done_ring,
                               clock, slot, stalls, stall_counts,
                               counters)
    finally:
        for view in planes.values():
            view.close()
        if counters is not None:
            counters.close()
        exec_ring.close()
        done_ring.close()


# ---------------------------------------------------------------------------
# parent side


class ProcessDispatch:
    """The placement the parent-side policies push ready tasks into.
    Implements the ``PlacementPolicy`` surface, but ``push`` serializes
    the task and routes it to the least-loaded worker's exec ring
    (batched: up to ``ipc_batch`` entries per frame) instead of a local
    deque. ``push_replay`` is the capture hook: while an iteration is
    being replayed against a built plane, ready roots are captured
    instead of shipped, and the plane executes them."""

    wants_replay_priorities = True       # receive (wd, sid) on replay

    def __init__(self, rt: "ProcessRuntime") -> None:
        self.rt = rt
        self.charge: Any = None          # wired by the policy ctor
        self.tracer: Any = NULL_TRACER   # ditto
        self.deques: List[Any] = []      # protocol compat (unused)
        self.scope_steals: Dict[int, int] = {}
        self.capture = False             # replay-plane capture mode
        self.discard = False             # plane drain: swallow pushes
        self.captured: List[Tuple[WorkDescriptor, int]] = []
        self.record_payloads = False     # keep payloads for image builds
        self.payload_of: Dict[int, Tuple[bytes, str]] = {}
        # wd_id -> (wd, widx, dispatch time); the dispatch time anchors
        # per-task timeout= enforcement (dispatch-to-done deadline)
        self.inflight: Dict[int, Tuple[WorkDescriptor, int, float]] = {}
        W = rt.num_workers
        self._load = [0] * W
        self._buffers: List[List[Tuple[int, bytes, str]]] = \
            [[] for _ in range(W)]
        # RLocks: a worker-death harvest holds its worker's lock while
        # draining done frames, whose completions may push back through
        # the same lock on the same (reaper) thread
        self._locks = [threading.RLock() for _ in range(W)]
        # paused[widx]: the supervisor is swapping this worker's rings;
        # buffer but do not ship (the buffer flushes to the replacement)
        self.paused = [False] * W
        self.sub_msgs = [0] * W          # exec frames shipped, per ring
        # plane-recovery routing: when an aborted plane iteration falls
        # back to live analysis, sids that already finished (or were
        # poisoned) on the plane are completed from here instead of
        # being re-shipped to a worker
        self.plane_done: Optional[Dict[int, str]] = None
        self.plane_ready: deque = deque()

    # -- PlacementPolicy surface ---------------------------------------
    def push(self, wd: WorkDescriptor) -> None:
        if self.capture:
            # a live push while capturing means the iteration diverged
            # from the recorded structure: ship the captured prefix
            self.flush_capture_live()
        payload = wd._proc_payload
        if self.record_payloads:
            self.payload_of[wd.wd_id] = (payload, wd.label)
        load = self._load
        widx = min(range(len(load)), key=load.__getitem__)
        load[widx] += 1
        if self.tracer.enabled:
            self.tracer.task_event(EV_READY, wd, 2 + widx)
        with self._locks[widx]:
            # inflight registration under the ring lock: the supervisor
            # harvests inflight-vs-buffered under the same lock, so a
            # task is never both "lost" (retried) and still buffered
            # for the replacement worker (double execution)
            self.inflight[wd.wd_id] = (wd, widx, time.perf_counter())
            buf = self._buffers[widx]
            buf.append((wd.wd_id, payload, wd.label))
            if len(buf) >= self.rt.ipc_batch and not self.paused[widx]:
                self._ship(widx)

    def push_replay(self, wd: WorkDescriptor, sid: int) -> None:
        if self.discard:
            return
        if self.plane_done is not None and sid in self.plane_done:
            # this sid already ran (or was poisoned) on the aborted
            # plane generation: complete it, don't re-execute it
            self.plane_ready.append((wd, sid))
            return
        if self.capture:
            self.captured.append((wd, sid))
            return
        self.push(wd)

    def pop(self, slot: int) -> Optional[WorkDescriptor]:
        return None                      # parent threads never run bodies

    def ready_count(self) -> int:
        return len(self.inflight)

    def note_executed(self, wd: WorkDescriptor, slot: int) -> None:
        pass

    def set_replay_priorities(self, levels, scope=None) -> None:
        pass                             # workers self-schedule the plane

    def clear_replay_priorities(self, scope=None) -> None:
        pass

    def stats(self) -> Dict[str, int]:
        return {"pushed": sum(self.sub_msgs)}

    # -- shipping -------------------------------------------------------
    def _ship(self, widx: int) -> None:
        """Encode + push the worker's buffer. Caller holds its lock."""
        buf = self._buffers[widx]
        if not buf:
            return
        self._buffers[widx] = []
        ring = self.rt._exec_rings[widx]
        plan = self.rt.fault_plan
        if plan is not None and plan.exec_frame_corrupt(widx):
            ring._corrupt_next = True
        ring.push(frame_exec(buf))
        self.sub_msgs[widx] += 1
        if self.charge is not None:
            self.charge.ipc_submit()
        if plan is not None:
            self.rt._chaos_shipped(len(buf))

    def flush_all(self) -> int:
        n = 0
        for widx in range(len(self._buffers)):
            if self._buffers[widx] and not self.paused[widx]:
                with self._locks[widx]:
                    if self._buffers[widx] and not self.paused[widx]:
                        self._ship(widx)
                        n += 1
        return n

    def flush_capture_live(self) -> None:
        self.capture = False
        cap, self.captured = self.captured, []
        for wd, _sid in cap:
            self.push(wd)

    def task_done(self, wd_id: int) -> Optional[Tuple[WorkDescriptor,
                                                      int]]:
        entry = self.inflight.pop(wd_id, None)
        if entry is not None:
            self._load[entry[1]] -= 1
        return entry


class ProcessRuntime:
    """Multi-process sibling of
    :class:`~repro_torch.core.runtime.TaskRuntime` (also reachable as
    ``TaskRuntime(backend="processes")``). Same task API, same modes,
    same policies — bodies run in worker processes.

    Constraints: task funcs/args must be picklable and module-level
    importable by name (a worker starts from the fork server, not from
    a copy of this process); no nested tasks; no multi-tenant scopes.
    Defaults to ``mode="sharded"`` — the configuration the GIL-escape
    argument is about. ``device="cuda"`` makes every worker create its
    CUDA context (with this process's float32 matmul precision) before
    it says it is ready; ``worker_starts`` records each worker's pid and
    start-up seconds (``boot_s`` of them to its first line, ``device_s``
    making its device context)."""

    backend = "processes"

    def __init__(self, num_workers: int = 4, mode: str = "sharded",
                 params: Optional[DDASTParams] = None,
                 trace: bool = False,
                 manager_eligible: Optional[set] = None,
                 num_shards: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 placement: Any = "round_robin",
                 replay: bool = False,
                 num_clients: int = 0,
                 delegation: bool = True, *,
                 backend: str = "processes",
                 ring_capacity: int = 1 << 20,
                 ipc_batch: int = 8,
                 trace_capacity: int = 1 << 14,
                 fault_plan: Optional[FaultPlan] = None,
                 max_respawns: int = 16,
                 shutdown_grace: float = 5.0,
                 metrics: bool = False,
                 metrics_interval_s: float = 0.002,
                 device: Optional[str] = None) -> None:
        if backend != "processes":
            raise ValueError("ProcessRuntime is the backend='processes' "
                             "driver")
        if mode not in PROC_MODES:
            raise ValueError(f"mode must be one of {PROC_MODES}")
        if num_clients:
            raise ValueError("multi-tenant scopes are not supported by "
                             "the process backend")
        if placement != "round_robin":
            raise ValueError("the process backend owns placement "
                             "(least-loaded worker rings); only "
                             "'round_robin' is accepted")
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers
        self.mode = mode
        self.params = params or DDASTParams()
        self.trace_enabled = trace
        self.num_shards = num_shards or max(2, num_workers)
        self.batch_size = batch_size
        self.replay = replay
        self.delegation = delegation
        self.ipc_batch = max(1, ipc_batch)
        self.ring_capacity = ring_capacity
        self.trace_capacity = trace_capacity
        # fault tolerance: the (test-only) injection plan, the respawn
        # budget (a crash-looping worker must not respawn forever), and
        # the teardown drain grace before escalation
        self.fault_plan = fault_plan
        self.max_respawns = max_respawns
        self.shutdown_grace = shutdown_grace
        self.device = device

        # slots: 0 = reaper/manager thread, 1 = main thread, 2+i = worker
        # process i (trace attribution only — workers hold no policy
        # state)
        self._trace_t0 = time.perf_counter()
        self.tracer = TraceRecorder(
            2 + num_workers,
            clock=lambda: time.perf_counter() - self._trace_t0,
            time_unit="s") if trace else NULL_TRACER
        self._dispatch = ProcessDispatch(self)
        self._dispatch.record_payloads = replay
        self.placement = self._dispatch
        self.policy: Any = make_policy(
            mode, 2,
            num_workers=2,
            params=self.params,
            placement=self._dispatch,
            manager_eligible=manager_eligible,
            main_slot=1,
            num_shards=self.num_shards,
            batch_size=batch_size,
            delegation=delegation,
            replay=replay,
            tracer=self.tracer)
        self.dispatcher = FunctionalityDispatcher()
        if self.policy.uses_idle_managers:
            self.dispatcher.register("policy", self.policy.callback,
                                     priority=10)

        from ..runtime import RuntimeStats
        self.stats = RuntimeStats()
        self._root = WorkDescriptor(func=None, label="main")
        self._root.state = TaskState.RUNNING
        self._stop = threading.Event()
        self._started = False
        self._torn_down = False
        self._main_thread: Optional[threading.Thread] = None
        self._reaper: Optional[threading.Thread] = None
        self._manager_thread: Optional[threading.Thread] = None
        self._procs: List[Any] = []
        self._exec_rings: List[ShmRing] = []
        self._done_rings: List[ShmRing] = []
        self._fbqs: List[Any] = []
        self._errors: List[Tuple[str, str]] = []   # (where, traceback)
        self._errors_lock = threading.Lock()
        self._lost: Optional[str] = None           # WorkerLost message
        self._last_check = 0.0
        self._shm_created: set = set()   # every segment ever created;
        #                                  the teardown leak scan's base
        # supervision state: serializes ring-list access between the
        # reaper (pump, single-worker respawn) and the main thread
        # (plane recovery swaps every ring)
        self._rings_lock = threading.RLock()
        self._plane_active = False
        self._plane_dead: Optional[int] = None     # widx seen dead
        self._recover_img: Optional[_ReplayImage] = None
        self.respawns = 0
        self.retries = 0
        self.poisoned = 0
        self.timeout_kills = 0
        self.transport_errors = 0
        self.trace_lost_n = 0
        self.zombies = 0
        self.leaked_shm: List[str] = []
        self.done_msgs = 0
        self.ctrl_msgs = 0
        self.iter_ipc: List[Tuple[int, int]] = []  # (submit, done) per
        self._ipc_mark = (0, 0)                    # root quiescence
        self._images: Dict[int, _ReplayImage] = {}
        self._image_graphs: Dict[int, Any] = {}    # keep graphs alive
        self._plane_lock = None
        self._ctx = None
        self.start_method: Optional[str] = None
        # (c) start-up: READY seen per worker, spawn stamps, and the
        # modules of every submitted task function (a respawned worker
        # imports them before it says it is ready)
        self._ready: List[bool] = []
        self._spawned_at: List[float] = []
        self._task_modules: set = set()
        self.worker_starts: List[Dict[str, Any]] = []
        self._matmul_precision: Optional[str] = None
        self._sem_created: set = set()   # semaphore names, leak-scanned
        # -- live metrics plane ----------------------------------------
        # The parent holds no per-task instruments (workers execute the
        # bodies); the shm counter plane IS the process backend's
        # instrument layer. The sampler rides the reaper loop + the
        # dispatcher's quiescence hook — never a task hot path.
        self.metrics_enabled = metrics
        self.instruments = NULL_METRICS
        self._counter_plane: Optional[ShmCounterPlane] = None
        self._plane_final: Optional[dict] = None
        self.sampler: Optional[MetricsSampler] = None
        if metrics:
            det = IncrementalDetector() if trace else None
            sampler = MetricsSampler(
                clock=lambda: time.perf_counter() - self._trace_t0,
                interval=metrics_interval_s,
                tracer=self.tracer if trace else None,
                detector=det)
            sampler.add_probe(
                "inflight", lambda: len(self._dispatch.inflight))
            sampler.add_probe("pending_msgs", self.policy.pending)
            sampler.add_probe(
                "ipc_submit_msgs",
                lambda: sum(self._dispatch.sub_msgs))
            sampler.add_probe("ipc_done_msgs", lambda: self.done_msgs)
            # plane probes return None until start() creates the plane
            sampler.add_probe(
                "busy_workers",
                lambda: (self._counter_plane.busy_count()
                         if self._counter_plane is not None else None))
            sampler.add_probe(
                "plane",
                lambda: (self._counter_plane.totals()
                         if self._counter_plane is not None else None))
            self.dispatcher.register_quiescent(
                "metrics-sampler", sampler.quiescent_callback,
                priority=2)
            self.sampler = sampler

    # ------------------------------------------------------------------
    # lifecycle
    def __enter__(self) -> "ProcessRuntime":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    def start(self) -> None:
        """Start the workers and wait until each has said it is ready
        (raises :class:`WorkerLost` if that takes READY_TIMEOUT_S, or the
        respawn budget runs out first)."""
        if self._started:
            return
        # (a) never fork: a CUDA context does not survive fork()
        methods = multiprocessing.get_all_start_methods()
        self.start_method = ("forkserver" if "forkserver" in methods
                             else "spawn")
        self._ctx = multiprocessing.get_context(self.start_method)
        if self.start_method == "forkserver":
            start_fork_server()
        if "torch" in sys.modules:
            self._matmul_precision = \
                sys.modules["torch"].get_float32_matmul_precision()
        self._trace_t0 = time.perf_counter()
        self._main_thread = threading.current_thread()
        # ONE lock, created before the workers exist, guards every
        # replay-plane mutation (latches, ready ring, remaining); a
        # plane recovery replaces it (the dead worker may have held it)
        self._plane_lock = self._new_lock()
        if self.metrics_enabled:
            self._counter_plane = ShmCounterPlane(self.num_workers)
            self._shm_created.add(self._counter_plane.name)
        self._ready = [False] * self.num_workers
        self._spawned_at = [0.0] * self.num_workers
        for i in range(self.num_workers):
            p, exec_ring, done_ring = self._spawn_worker(i)
            self._exec_rings.append(exec_ring)
            self._done_rings.append(done_ring)
            self._procs.append(p)
        self._reaper = threading.Thread(target=self._reaper_loop,
                                        name="proc-reaper", daemon=True)
        self._reaper.start()
        if self.policy.needs_manager_thread:
            self._manager_thread = threading.Thread(
                target=self._manager_loop, name="proc-manager",
                daemon=True)
            self._manager_thread.start()
        self._started = True
        deadline = time.perf_counter() + READY_TIMEOUT_S
        while not all(self._ready):
            if self._lost is not None:
                raise WorkerLost(self._lost)
            if time.perf_counter() > deadline:
                waiting = [w for w, r in enumerate(self._ready) if not r]
                raise WorkerLost(f"workers {waiting} not ready after "
                                 f"{READY_TIMEOUT_S} s")
            time.sleep(1e-3)

    def _new_lock(self):
        lock = self._ctx.Lock()
        if lock._semlock.name is not None:
            self._sem_created.add(lock._semlock.name)
        return lock

    def _new_queue(self):
        q = self._ctx.SimpleQueue()
        for lock in (q._rlock, q._wlock):
            if lock is not None and lock._semlock.name is not None:
                self._sem_created.add(lock._semlock.name)
        return q

    def _spawn_worker(self, widx: int) -> Tuple[Any, ShmRing, ShmRing]:
        """Create one worker process with a fresh exec/done ring pair.
        Used both at start() and by the supervisor's respawn path."""
        exec_fbq = self._new_queue()
        done_fbq = self._new_queue()
        exec_ring = ShmRing(self.ring_capacity, fallback=exec_fbq)
        done_ring = ShmRing(self.ring_capacity, fallback=done_fbq)
        self._fbqs += [exec_fbq, done_fbq]
        self._shm_created.update((exec_ring.name, done_ring.name))
        plan = self.fault_plan
        p = self._ctx.Process(
            target=_worker_main,
            args=(widx, 2 + widx, exec_ring.name, done_ring.name,
                  exec_fbq, done_fbq, self._plane_lock, self._trace_t0,
                  plan.worker_stalls() if plan is not None else (),
                  plan.ignore_sigterm if plan is not None else False,
                  self._counter_plane.name
                  if self._counter_plane is not None else "",
                  sorted(self._task_modules), self.device,
                  self._matmul_precision),
            name=f"procworker-{widx}", daemon=True)
        self._ready[widx] = False
        self._spawned_at[widx] = time.perf_counter() - self._trace_t0
        p.start()
        # a full exec ring + live worker means a slow consumer (long
        # task body), not a dead one: let push() keep waiting
        exec_ring.consumer_alive = p.is_alive
        return p, exec_ring, done_ring

    def _respawn_worker(self, widx: int, count: bool = True) -> None:
        """Swap in a fresh process + ring pair at ``widx``. The caller
        holds ``_rings_lock``, has joined the old process, and keeps
        ``dispatch.paused[widx]`` set until the swap lands (so no frame
        ships to the ring being retired)."""
        old_exec = self._exec_rings[widx]
        old_done = self._done_rings[widx]
        p, exec_ring, done_ring = self._spawn_worker(widx)
        self._exec_rings[widx] = exec_ring
        self._done_rings[widx] = done_ring
        self._procs[widx] = p
        for ring in (old_exec, old_done):
            ring.close()
            ring.unlink()
        if count:
            self.respawns += 1
        if self.tracer.enabled:
            self.tracer.mgr_event(EV_RESPAWN, 2 + widx,
                                  {"widx": widx, "pid": p.pid})

    def shutdown(self) -> None:
        if self._torn_down:
            return
        err: Optional[BaseException] = None
        if self._started and self._lost is None:
            try:
                self.taskwait()
            except BaseException as e:
                err = e
        self._teardown()
        self._aggregate_stats()
        if err is not None:
            raise err

    def _teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        self._stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=5.0)
        if self._manager_thread is not None:
            self._manager_thread.join(timeout=5.0)
        for ring in self._exec_rings:
            try:
                # drop the liveness probe for teardown: a stuck-but-
                # alive worker must not spin this push forever — it is
                # terminated just below anyway
                ring.consumer_alive = None
                ring.push(frame_ctrl(OP_SHUTDOWN), spin_s=0.2)
                self.ctrl_msgs += 1
            except BufferError:          # pragma: no cover - dead worker
                pass
        # escalation ladder: drain-join -> SIGTERM -> SIGKILL. Each
        # rung only fires for workers the previous one failed to stop;
        # a worker still alive at the SIGKILL rung counts as a zombie
        # (it ignored or blocked SIGTERM) in RuntimeStats.
        grace = max(0.1, self.shutdown_grace)
        deadline = time.perf_counter() + grace
        while any(p.is_alive() for p in self._procs) \
                and time.perf_counter() < deadline:
            self._pump_dones()           # drain final Done frames
            time.sleep(1e-3)
        for p in self._procs:
            if p.is_alive():
                p.terminate()            # SIGTERM
        for p in self._procs:
            if p.is_alive():
                p.join(timeout=min(2.0, grace))
        for p in self._procs:
            if p.is_alive():             # survived SIGTERM: escalate
                self.zombies += 1
                p.kill()                 # SIGKILL
        for p in self._procs:
            p.join(timeout=2.0)
        self._pump_dones()
        for ring in self._exec_rings + self._done_rings:
            ring.close()
            ring.unlink()
            ring.fallback = None
        for img in self._images.values():
            img.close_unlink()
        if self._counter_plane is not None:
            # final scrape before the segment dies: _aggregate_stats
            # runs after teardown, so metrics() serves this snapshot
            self._plane_final = self._counter_plane.snapshot()
            self._counter_plane.close_unlink()
            self._counter_plane = None
        # close and drop the queues, and drop the plane lock: outside
        # fork their semaphores are named files (/dev/shm/sem.mp-*),
        # unlinked when the last reference goes
        while self._fbqs:
            try:
                self._fbqs.pop().close()
            except Exception:            # pragma: no cover - teardown
                pass
        self._plane_lock = None
        # post-unlink leak scan: any segment or semaphore this runtime
        # ever created that still exists in /dev/shm leaked (reported,
        # not raised — the chaos soak asserts the list is empty)
        try:
            live = set(os.listdir("/dev/shm"))
        except OSError:                  # pragma: no cover - non-Linux
            live = set()
        self.leaked_shm = sorted(
            [n for n in self._shm_created if n.lstrip("/") in live]
            + [n for n in self._sem_created
               if "sem." + n.lstrip("/") in live])

    def _aggregate_stats(self) -> None:
        self.stats.wall_s = time.perf_counter() - self._trace_t0
        self.stats.ddast_callback_entries = self.policy.callback_entries
        st = self.policy.stats()
        self.stats.messages_processed = st["messages_processed"]
        self.stats.lock_acquisitions = st["lock_acquisitions"]
        self.stats.lock_wait_s = st["lock_wait_s"]
        self.stats.max_in_graph = st["max_in_graph"]
        self.stats.total_edges = st["total_edges"]
        self.stats.shard_messages = st.get("shard_messages", [])
        self.stats.shard_lock_wait_s = st.get("shard_lock_wait_s", [])
        self.stats.delegated_portions = st.get("delegated_portions", 0)
        self.stats.combined_drains = st.get("combined_drains", 0)
        self.stats.shard_lock_handoffs = list(
            st.get("shard_lock_handoffs", []))
        self.stats.ipc_submit_msgs = sum(self._dispatch.sub_msgs)
        self.stats.ipc_done_msgs = self.done_msgs
        self.stats.ipc_ctrl_msgs = self.ctrl_msgs
        self.stats.ipc_iter = list(self.iter_ipc)
        self.stats.worker_respawns = self.respawns
        self.stats.task_retries = self.retries
        self.stats.tasks_poisoned = self.poisoned
        self.stats.timeout_kills = self.timeout_kills
        self.stats.transport_errors = self.transport_errors
        self.stats.trace_lost = self.trace_lost_n
        self.stats.zombie_workers = self.zombies
        self.stats.leaked_shm = list(self.leaked_shm)
        if self.tracer.enabled:
            self.stats.events = self.tracer.events()
            self.stats.trace_dropped = self.tracer.dropped
        rep = st.get("replay")
        if rep:
            self.stats.replay_iterations = rep["replay_iterations"]
            self.stats.replayed_tasks = rep["replayed_tasks"]
            self.stats.replay_invalidations = rep["invalidations"]
            self.stats.replay_cache_hits = rep["cache_hits"]
        if self.metrics_enabled:
            self.stats.metrics = self.metrics()

    def shm_names(self) -> List[str]:
        """Every shared-memory segment this runtime owns (rings + replay
        planes) — the leak-check hook for tests."""
        names = [r.name for r in self._exec_rings + self._done_rings]
        for img in self._images.values():
            names += img.shm_names()
        if self._counter_plane is not None:
            names.append(self._counter_plane.name)
        return names

    def metrics(self) -> Dict[str, Any]:
        """Live metrics snapshot: the shm counter plane scraped in
        place (zero IPC frames), parent-side gauges, and the sampler's
        series rings. Callable while a run is in flight; after teardown
        it serves the final pre-unlink scrape."""
        plane = (self._counter_plane.snapshot()
                 if self._counter_plane is not None
                 else self._plane_final)
        out: Dict[str, Any] = {
            "time_unit": "s",
            "backend": "processes",
            "workers": plane or {},
            "gauges": {
                "inflight": len(self._dispatch.inflight),
                "pending_msgs": self.policy.pending(),
                "ipc_submit_msgs": sum(self._dispatch.sub_msgs),
                "ipc_done_msgs": self.done_msgs,
            },
        }
        if self.sampler is not None:
            out["sampler"] = self.sampler.snapshot()
        return out

    # ------------------------------------------------------------------
    # task API
    def task(self, func, *args, deps=(), label: str = "task",
             retries: int = 0, timeout: Optional[float] = None
             ) -> WorkDescriptor:
        """Submit one task. ``retries=N`` lets the supervisor re-dispatch
        the task up to N times after a worker death, per-task timeout, or
        body exception (at-least-once: retried bodies must be
        idempotent); 0 preserves fail-fast ``WorkerLost`` semantics.
        ``timeout=`` (seconds, dispatch-to-done, counted from the
        worker's READY if it was not yet up) makes the supervisor
        SIGKILL a worker stuck past the deadline and retry or poison the
        task."""
        if not self._started:
            raise RuntimeError("ProcessRuntime.task() before start(): "
                               "use it as a context manager")
        if threading.current_thread() is not self._main_thread:
            raise RuntimeError("the process backend supports submissions "
                               "from the starting thread only (no nested "
                               "tasks, no client threads)")
        try:
            payload = pickle.dumps((func, args), protocol=4)
        except Exception as e:
            raise ValueError(
                f"process backend requires picklable task funcs/args "
                f"(task {label!r}): {e}") from e
        from ..runtime import _parse_deps
        wd = WorkDescriptor(func=func, args=args, deps=_parse_deps(deps),
                            label=label, parent=self._root,
                            retries=max(0, retries), timeout=timeout)
        wd._proc_payload = payload
        mod = getattr(func, "__module__", None)
        if mod and mod not in ("__main__", "__mp_main__"):
            self._task_modules.add(mod)
        self._maybe_enter_capture()
        if self.tracer.enabled:
            self.tracer.task_event(EV_CREATED, wd, 1)
        self.policy.submit(wd, 1)
        self._after_submit_capture_check()
        return wd

    def taskwait(self) -> None:
        pol = self.policy
        d = self._dispatch
        pol.flush(0)
        pol.flush(1)
        if d.capture:
            g = getattr(pol, "replay_graph", None)
            img = self._images.get(id(g)) if g is not None else None
            if img is not None and pol.steady_iteration_complete():
                if self._plane_iteration(img):
                    return
                # the plane aborted mid-iteration (worker death):
                # recovery routed already-finished sids through
                # d.plane_done and re-shipped the rest live — fall
                # through to the generic drain loop
            else:
                d.flush_capture_live()
        d.flush_all()
        while True:
            if self._lost is not None:
                raise WorkerLost(self._lost)
            if self._root.num_children_alive == 0 and not pol.pending() \
                    and not d.inflight and not d.plane_ready:
                break
            worked = self._drain_plane_ready()
            worked += pol.callback(1) if pol.uses_idle_managers else 0
            if pol.pending() and not worked:
                worked += pol.drain_all()
            worked += d.flush_all()
            if not worked:
                time.sleep(2e-5)
        if d.plane_done is not None:     # recovery iteration finished
            d.plane_done = None
            d.plane_ready.clear()
            self._recover_img = None
        self._quiesce()
        self._raise_task_errors()

    # ------------------------------------------------------------------
    # replay-plane machinery
    def _maybe_enter_capture(self) -> None:
        if not self.replay:
            return
        d = self._dispatch
        if d.capture or d.captured:
            return
        pol = self.policy
        if getattr(pol, "replay_state", None) != REPLAYING:
            return
        if pol._diverged or pol._iter_started:
            return                       # only at an iteration boundary
        g = pol.replay_graph
        if g is not None and id(g) in self._images:
            d.capture = True

    def _after_submit_capture_check(self) -> None:
        d = self._dispatch
        if not d.capture:
            return
        pol = self.policy
        g = getattr(pol, "replay_graph", None)
        if pol._diverged or pol.replay_state == RECORDING \
                or g is None or id(g) not in self._images:
            d.flush_capture_live()

    def _plane_iteration(self, img: _ReplayImage) -> bool:
        """Steady-state replayed iteration: every task of the frozen
        graph runs worker-side off the shared plane. Cross-process cost:
        one CTRL(ITER) frame per worker — zero Submit/Done messages.

        Returns True when the iteration completed on the plane; False
        when a worker died mid-iteration and :meth:`_recover_plane`
        invalidated this generation (the caller falls back to the live
        drain loop to finish the iteration)."""
        pol = self.policy
        d = self._dispatch
        self._plane_dead = None
        self._plane_active = True
        try:
            with self._plane_lock:
                img.reset()
            with self._rings_lock:
                for widx, ring in enumerate(self._exec_rings):
                    ring.push(frame_ctrl(OP_ITER, dict(img.desc)))
                    self.ctrl_msgs += 1
            plan = self.fault_plan
            if plan is not None:
                doomed = plan.on_iter_broadcast()
                if doomed:
                    time.sleep(5e-3)     # let workers claim some sids
                    for w in doomed:
                        self._kill_worker_proc(w)
            fired: set = set()
            while img.remaining() != 0:
                if self._lost is not None:
                    stuck = ", ".join(img.unfinished_labels()[:4])
                    raise WorkerLost(
                        f"{self._lost} (replay plane stalled; "
                        f"unfinished: {stuck})")
                if self._plane_dead is not None:
                    self._recover_plane(img)
                    return False
                self._plane_timeouts(img, fired)
                time.sleep(2e-5)
        finally:
            self._plane_active = False
        d.capture = False
        d.captured = []
        d.discard = True
        try:
            tr = self.tracer
            for sid in range(img.n):
                wd = pol._iter_wds[sid]
                t0, t1 = img.times(sid)
                wd.exec_dur = t1 - t0
                wd.exec_span = (t0, t1)
                wd.mark_finished()
                if tr.enabled:
                    slot = img.exec_slot(sid)
                    tr.ingest([(t0, EV_START, wd.wd_id, slot, wd.label,
                                wd.scope, None),
                               (t1, EV_END, wd.wd_id, slot, wd.label,
                                wd.scope, None)])
                pol.complete(wd, 0)
                self.stats.tasks_executed += 1
        finally:
            d.discard = False
        self._quiesce()
        self._raise_task_errors()
        return True

    def _plane_timeouts(self, img: _ReplayImage, fired: set) -> None:
        """Per-task ``timeout=`` enforcement during a plane iteration:
        a sid claimed (t0 stamped at pop) but unfinished past its
        deadline gets its worker SIGKILLed; the death flows through
        :meth:`_recover_plane`, which classifies the sid as a culprit
        and retries or poisons it."""
        wds = getattr(self.policy, "_iter_wds", None)
        if not wds:
            return
        now = time.perf_counter() - self._trace_t0
        for sid in range(img.n):
            if sid in fired:
                continue
            wd = wds[sid]
            if wd is None or wd.timeout is None:
                continue
            t0, t1 = img.times(sid)
            if t0 == 0.0 or t1 != 0.0 or now - t0 <= wd.timeout:
                continue
            slot = img.exec_slot(sid)
            if slot < 2:                 # pragma: no cover - defensive
                continue
            fired.add(sid)
            wd._timed_out = True
            self.timeout_kills += 1
            if self.tracer.enabled:
                self.tracer.task_event(EV_TIMEOUT_KILL, wd, slot,
                                       {"timeout": wd.timeout})
            self._kill_worker_proc(slot - 2)

    def _recover_plane(self, img: _ReplayImage) -> None:
        """A worker died mid plane iteration. Invalidate ONLY this
        generation: wait for the survivors to stall, kill + join every
        worker (a survivor may be blocked on the plane lock the dead
        worker held), classify each sid — finished, culprit (claimed by
        a genuinely dead worker: retry or poison), or innocent (claimed
        by a worker we killed ourselves: rerun free) — then respawn the
        fleet against a fresh plane lock and route the remainder of the
        iteration through live analysis via ``dispatch.plane_done``."""
        pol = self.policy
        d = self._dispatch
        prev = img.remaining()
        stable = time.perf_counter()
        deadline = stable + 2.0
        while time.perf_counter() < deadline and img.remaining() != 0:
            rem = img.remaining()
            if rem != prev:
                prev, stable = rem, time.perf_counter()
            elif time.perf_counter() - stable > 0.05:
                break                    # progress stalled: harvest now
            time.sleep(1e-3)
        with self._rings_lock:
            dead = {w for w, p in enumerate(self._procs)
                    if not p.is_alive()}
            for w in range(self.num_workers):
                self._kill_worker_proc(w)
            for p in self._procs:
                p.join(timeout=5.0)
            self._pump_dones()           # final DONE_PLANE_ERROR frames
            done_map: Dict[int, str] = {}
            culprits: List[int] = []
            for sid in range(img.n):
                t0, t1 = img.times(sid)
                slot = img.exec_slot(sid)
                if t1 != 0.0:
                    done_map[sid] = "done"
                elif slot >= 2 and (slot - 2) in dead:
                    culprits.append(sid)
                # else: never claimed, or claimed by a worker we killed
                # ourselves — reruns live without burning a retry
            wds = pol._iter_wds
            hard = [sid for sid in culprits
                    if wds[sid].retries == 0
                    and not getattr(wds[sid], "_timed_out", False)]
            if hard:
                labels = ", ".join(wds[sid].label for sid in hard[:4])
                self._lost = (
                    f"worker process(es) {sorted(dead)} died mid "
                    f"replay-plane iteration with {len(culprits)} "
                    f"claimed task(s) in flight: {labels}")
                raise WorkerLost(self._lost)
            if self.tracer.enabled:
                for w in sorted(dead):
                    self.tracer.mgr_event(
                        EV_WORKER_LOST, 2 + w,
                        {"widx": w, "plane": True,
                         "lost": [wds[sid].label for sid in culprits
                                  if img.exec_slot(sid) == 2 + w]})
            self.trace_lost_n += len(culprits)
            for sid in culprits:
                wd = wds[sid]
                reason = "timeout" if getattr(wd, "_timed_out", False) \
                    else "worker_lost"
                wd.attempts.append(
                    {"worker": img.exec_slot(sid) - 2, "reason": reason,
                     "t": time.perf_counter() - self._trace_t0})
                if self.tracer.enabled:
                    self.tracer.task_event(
                        EV_TRACE_LOST, wd, img.exec_slot(sid), None)
                if wd.retries_left > 0:
                    wd.retries_left -= 1
                    wd._timed_out = False
                    self.retries += 1
                    if self.tracer.enabled:
                        self.tracer.task_event(
                            EV_RETRY, wd, 1,
                            {"attempt": len(wd.attempts),
                             "reason": reason})
                else:
                    done_map[sid] = "poisoned"
                    self.poisoned += 1
                    with self._errors_lock:
                        self._errors.append(
                            (wd.label,
                             f"{reason} on the replay plane (retries "
                             f"exhausted)", list(wd.attempts)))
            if self.respawns + len(dead) > self.max_respawns:
                self._lost = (f"respawn budget ({self.max_respawns}) "
                              f"exhausted during plane recovery")
                raise WorkerLost(self._lost)
            # fresh plane lock: the old one may be held by a dead
            # process, which would deadlock every future iteration
            self._plane_lock = self._new_lock()
            for w in range(self.num_workers):
                self._respawn_worker(w, count=(w in dead))
        # route the rest of the iteration through live analysis: roots
        # re-enter via push_replay, which completes plane-finished (and
        # poisoned) sids from plane_done instead of re-executing them
        d.plane_done = done_map
        self._recover_img = img
        d.capture = False
        cap, d.captured = d.captured, []
        for wd, sid in cap:
            d.push_replay(wd, sid)

    def _drain_plane_ready(self) -> int:
        """Complete tasks the aborted plane generation already ran (or
        poisoned): stamp their plane times, ingest trace stamps, and
        cascade through the policy so successors become ready."""
        d = self._dispatch
        if not d.plane_ready:
            return 0
        pol = self.policy
        img = self._recover_img
        n = 0
        while d.plane_ready:
            wd, sid = d.plane_ready.popleft()
            if d.plane_done.get(sid) == "done" and img is not None:
                t0, t1 = img.times(sid)
                wd.exec_dur = t1 - t0
                wd.exec_span = (t0, t1)
                if self.tracer.enabled:
                    slot = img.exec_slot(sid)
                    self.tracer.ingest(
                        [(t0, EV_START, wd.wd_id, slot, wd.label,
                          wd.scope, None),
                         (t1, EV_END, wd.wd_id, slot, wd.label,
                          wd.scope, None)])
                self.stats.tasks_executed += 1
            wd.mark_finished()
            pol.complete(wd, 0)
            n += 1
        return n

    def _quiesce(self) -> None:
        pol = self.policy
        sid_snapshot = None
        if self.replay and getattr(pol, "replay_state", None) == RECORDING:
            sid_snapshot = dict(pol._rec_sid_of)
        pol.notify_quiescent(True)
        if self.tracer.enabled:
            self.tracer.quiesce(
                {"scope": None,
                 "replay_iterations": replay_iterations_of(pol, None)})
        self.dispatcher.notify_quiescent(1)
        sub = sum(self._dispatch.sub_msgs)
        done = self.done_msgs
        self.iter_ipc.append((sub - self._ipc_mark[0],
                              done - self._ipc_mark[1]))
        self._ipc_mark = (sub, done)
        if sid_snapshot is not None:
            self._maybe_build_image(sid_snapshot)

    def _maybe_build_image(self, sid_snapshot: Dict[int, int]) -> None:
        """A recording may just have frozen: materialize its replay
        plane in shared memory. The process backend admits no nested
        tasks, so every recording is flat (one namespace) and the
        recording's sid numbering is exactly the frozen graph's."""
        pol = self.policy
        d = self._dispatch
        payload_of, d.payload_of = d.payload_of, {}
        if pol.replay_state != REPLAYING:
            return
        g = pol.replay_graph
        if g is None or id(g) in self._images:
            self._prune_images()
            return
        if len(sid_snapshot) != g.n:
            return                       # not this recording's graph
        entries: List[Optional[Tuple[bytes, str]]] = [None] * g.n
        for wd_id, sid in sid_snapshot.items():
            entries[sid] = payload_of.get(wd_id)
        if any(e is None for e in entries):
            return                       # payload missing: stay live
        self._images[id(g)] = _ReplayImage(g, entries)
        self._image_graphs[id(g)] = g
        self._prune_images()

    def _prune_images(self) -> None:
        pol = self.policy
        cache = getattr(pol, "_cache", {})
        alive = {id(g) for g in cache.values()}
        g = getattr(pol, "replay_graph", None)
        if g is not None:
            alive.add(id(g))
        for key in list(self._images):
            if key not in alive:
                self._images.pop(key).close_unlink()
                self._image_graphs.pop(key, None)

    # ------------------------------------------------------------------
    # reaper: the single consumer of every Done ring
    def _reaper_loop(self) -> None:
        pol = self.policy
        while not self._stop.is_set():
            with self._rings_lock:
                n = self._pump_dones()
            n += self._dispatch.flush_all()
            if pol.uses_idle_managers:
                n += pol.callback(0)
            self._check_workers()
            # the reaper never reaches the dispatcher's notify_idle
            # path, so it ticks the sampler directly between polls
            if self.sampler is not None:
                self.sampler.tick()
            if not n:
                time.sleep(2e-5)

    def _pump_dones(self) -> int:
        """Drain every Done ring. Callers hold ``_rings_lock`` (except
        teardown, which runs after the reaper joined). A CRC failure on
        a frame is a structured transport error: count it and kill the
        producing worker — the supervision path respawns it and retries
        its in-flight tasks."""
        n = 0
        plan = self.fault_plan
        for widx in range(len(self._done_rings)):
            ring = self._done_rings[widx]
            while True:
                try:
                    frame = ring.pop()
                except RingCorruption:
                    self.transport_errors += 1
                    if not self._torn_down:
                        self._kill_worker_proc(widx)
                    break
                if frame is None:
                    break
                if plan is not None and frame[0] == K_DONE:
                    act = plan.on_done_frame(widx)
                    if act == "drop":    # lost done: only timeout=
                        continue         # recovers the task
                    if isinstance(act, tuple):
                        time.sleep(act[1])
                n += 1
                self._handle_frame(frame, widx)
        return n

    def _handle_frame(self, frame: bytes, widx: int) -> None:
        kind = frame[0]
        if kind == K_READY:
            self._on_ready(widx, serial.parse(frame)[1])
            return
        if kind == K_TRACE:              # pragma: no cover - legacy
            if self.tracer.enabled:
                self.tracer.ingest(serial.parse(frame)[1])
            return
        if kind != K_DONE:               # pragma: no cover - defensive
            return
        self.done_msgs += 1
        if self.policy.charge is not None:
            self.policy.charge.ipc_done()
        for wd_id, t0, t1, status, blob in decode_done_batch(frame, 1):
            if status == DONE_PLANE_ERROR:
                with self._errors_lock:
                    self._errors.append(
                        (f"replay sid {wd_id}",
                         blob.decode("utf-8", "replace"), []))
                continue
            entry = self._dispatch.task_done(wd_id)
            if entry is None:            # pragma: no cover - defensive
                continue
            wd, w, _t_enq = entry
            wd.exec_dur = t1 - t0
            wd.exec_span = (t0, t1)
            if self.tracer.enabled:
                # parent-side lifecycle reconstruction: workers ship no
                # trace frames; START/END come from the done stamps, so
                # a crashed worker costs only its un-acked tasks' events
                self.tracer.ingest(
                    [(t0, EV_START, wd.wd_id, 2 + w, wd.label,
                      wd.scope, None),
                     (t1, EV_END, wd.wd_id, 2 + w, wd.label,
                      wd.scope, None)])
            if status == DONE_OK and blob:
                try:
                    wd.result = pickle.loads(blob)
                except Exception:        # pragma: no cover - defensive
                    pass
            elif status == DONE_ERROR:
                if wd.retries_left > 0:
                    self._retry(wd, w, "error")
                    continue             # not finished: re-dispatched
                self.poisoned += 1
                with self._errors_lock:
                    self._errors.append(
                        (wd.label, blob.decode("utf-8", "replace"),
                         list(wd.attempts)))
            wd.mark_finished()
            self.policy.complete(wd, 0)
            self.stats.tasks_executed += 1

    def _on_ready(self, widx: int, info: Dict[str, Any]) -> None:
        """(c) Worker ``widx`` is up: record its start-up, restart the
        deadline of every task dispatched to it before now, and report a
        start-up error as a task failure."""
        d = self._dispatch
        now = time.perf_counter()
        with d._locks[widx]:
            self._ready[widx] = True
            for wd_id, (wd, w, _t) in list(d.inflight.items()):
                if w == widx:
                    d.inflight[wd_id] = (wd, w, now)
        self.worker_starts.append(
            {"widx": widx, "pid": info["pid"],
             "startup_s": info["t"] - self._spawned_at[widx],
             # to the worker's first line (the fork server's fork and
             # the import of the caller's script), and its device's
             "boot_s": info["t_main"] - self._spawned_at[widx],
             "device_s": info["t"] - info["t_device"]})
        if info["error"] is not None:
            with self._errors_lock:
                self._errors.append((f"worker {widx} start-up",
                                     info["error"], []))

    # ------------------------------------------------------------------
    # supervision: death detection, timeouts, respawn, retry/poison
    def _check_workers(self) -> None:
        now = time.perf_counter()
        if now - self._last_check < 5e-3 or self._lost is not None:
            return
        self._last_check = now
        if not self._plane_active:
            self._timeout_scan(now)
        for widx, p in enumerate(self._procs):
            if p.is_alive():
                continue
            if self._plane_active:
                # the main thread owns plane recovery: just flag it
                self._plane_dead = widx
                return
            self._handle_worker_death(widx)
            return                       # one death per tick; the next
            #                              tick catches any others

    def _timeout_scan(self, now: float) -> None:
        """Enforce per-task ``timeout=``: a task dispatched longer ago
        than its deadline gets its worker SIGKILLed (the only way to
        interrupt a stuck body in another process); the death handler
        then retries or poisons it with reason ``timeout``."""
        for wd, widx, t_enq in list(self._dispatch.inflight.values()):
            if wd.timeout is None or getattr(wd, "_timed_out", False):
                continue
            if not self._ready[widx]:    # (c) its clock starts at READY
                continue
            if now - t_enq <= wd.timeout:
                continue
            wd._timed_out = True
            self.timeout_kills += 1
            if self.tracer.enabled:
                self.tracer.task_event(EV_TIMEOUT_KILL, wd, 2 + widx,
                                       {"timeout": wd.timeout})
            self._kill_worker_proc(widx)

    def _handle_worker_death(self, widx: int) -> None:
        """Runs on the reaper thread when worker ``widx`` is found dead
        outside a plane iteration: harvest its final done frames, split
        its in-flight tasks into buffered (never shipped — they flush
        to the replacement) and lost, fail fast if a lost task has
        ``retries=0`` (and did not time out), otherwise respawn the
        worker and retry or poison each lost task."""
        d = self._dispatch
        p = self._procs[widx]
        p.join(timeout=5.0)
        pid, exitcode = p.pid, p.exitcode
        with d._locks[widx]:
            d.paused[widx] = True        # buffer, don't ship, while the
            #                              rings are being swapped
        with self._rings_lock:
            self._pump_dones()           # completed != lost
            with d._locks[widx]:
                buffered = {e[0] for e in d._buffers[widx]}
                lost = [wd for wd_id, (wd, w, _t)
                        in list(d.inflight.items())
                        if w == widx and wd_id not in buffered]
                for wd in lost:
                    d.task_done(wd.wd_id)
            hard = [wd for wd in lost if wd.retries == 0
                    and not getattr(wd, "_timed_out", False)]
            if hard:
                labels = ", ".join(wd.label for wd in hard[:4])
                self._lost = (
                    f"worker process {widx} (pid {pid}, exitcode "
                    f"{exitcode}) died with {len(lost)} task(s) in "
                    f"flight: {labels or 'none'}")
                return                   # retries=0 keeps fail-fast
            #                              semantics: no respawn
            if self.tracer.enabled:
                self.tracer.mgr_event(
                    EV_WORKER_LOST, 2 + widx,
                    {"widx": widx, "pid": pid, "exitcode": exitcode,
                     "lost": [wd.label for wd in lost]})
                for wd in lost:
                    # their START events can never be reconstructed:
                    # the done stamps died with the worker
                    self.tracer.task_event(EV_TRACE_LOST, wd,
                                           2 + widx, None)
            self.trace_lost_n += len(lost)
            if self.respawns >= self.max_respawns:
                self._lost = (f"respawn budget ({self.max_respawns}) "
                              f"exhausted after worker {widx} died")
                return
            self._respawn_worker(widx)
        with d._locks[widx]:
            d.paused[widx] = False       # buffered tasks flush to the
            #                              replacement via flush_all
        for wd in lost:
            reason = "timeout" if getattr(wd, "_timed_out", False) \
                else "worker_lost"
            self._retry_or_poison(wd, widx, reason)

    def _retry(self, wd: WorkDescriptor, widx: int, reason: str) -> None:
        wd.retries_left -= 1
        wd._timed_out = False            # fresh deadline on re-dispatch
        wd.attempts.append({"worker": widx, "reason": reason,
                            "t": time.perf_counter() - self._trace_t0})
        self.retries += 1
        if self.tracer.enabled:
            self.tracer.task_event(EV_RETRY, wd, 2 + widx,
                                   {"attempt": len(wd.attempts),
                                    "reason": reason})
        self._dispatch.push(wd)

    def _retry_or_poison(self, wd: WorkDescriptor, widx: int,
                         reason: str) -> None:
        if wd.retries_left > 0:
            self._retry(wd, widx, reason)
            return
        wd.attempts.append({"worker": widx, "reason": reason,
                            "t": time.perf_counter() - self._trace_t0})
        self.poisoned += 1
        with self._errors_lock:
            self._errors.append(
                (wd.label,
                 f"{reason} (retries exhausted after "
                 f"{len(wd.attempts)} attempt(s))", list(wd.attempts)))
        wd.mark_finished()
        self.policy.complete(wd, 0)

    def _kill_worker_proc(self, widx: int) -> None:
        p = self._procs[widx]
        if p.pid is None:                # pragma: no cover - defensive
            return
        try:
            os.kill(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass                         # already gone

    def _chaos_shipped(self, count: int) -> None:
        """Fault-plan hook, called by dispatch after shipping a frame of
        ``count`` tasks: fire any kill whose threshold was crossed."""
        plan = self.fault_plan
        if plan is None:                 # pragma: no cover - defensive
            return
        doomed = plan.on_task_shipped(count)
        if doomed:
            time.sleep(2e-3)             # let the victim pop the frame
            for widx in doomed:
                self._kill_worker_proc(widx)

    def _raise_task_errors(self) -> None:
        with self._errors_lock:
            if not self._errors:
                return
            errors, self._errors = self._errors, []
        where, tb, attempts = errors[0]
        more = f" (+{len(errors) - 1} more)" if len(errors) > 1 else ""
        att = f" after {len(attempts)} attempt(s)" if attempts else ""
        raise TaskFailed(f"task {where!r} raised in a worker "
                         f"process{att}{more}:\n{tb}", failures=errors)

    def _manager_loop(self) -> None:
        while not self._stop.is_set():
            if self.policy.drain_all() == 0:
                time.sleep(1e-6)

    # -- probes mirroring TaskRuntime ----------------------------------
    def ready_count(self) -> int:
        return self._dispatch.ready_count()

    def in_graph_count(self) -> int:
        return self.policy.in_graph()
