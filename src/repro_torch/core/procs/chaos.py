"""Copy of `repro/core/procs/chaos.py`.

Deterministic fault injection for the process backend.

A :class:`FaultPlan` is a seeded script of failures the driver consults
at well-defined points (a test-only hook: pass it as
``ProcessRuntime(fault_plan=...)``):

  * ``kill_worker(widx, after_tasks=k)`` — SIGKILL worker ``widx`` the
    moment the k-th task has been shipped to the exec rings ("kill
    worker W before task K+1"). With ``ipc_batch=1`` the trigger point
    is exact; larger batches quantize it to a frame boundary.
  * ``kill_worker_at_iter(widx, nth_iter=n)`` — SIGKILL worker ``widx``
    just after the n-th replay-plane ITER broadcast, exercising the
    plane-recovery path.
  * ``stall_body(label_contains, stall_s, times=t)`` — each worker
    process sleeps ``stall_s`` before the first ``t`` bodies whose
    label matches (per process: a respawned worker stalls again), the
    lever for driving tasks past their ``timeout=``.
  * ``drop_done(widx, nth)`` / ``delay_done(widx, nth, delay_s)`` —
    the reaper swallows or delays the n-th done frame from worker
    ``widx`` (a lost done looks like a stuck task: only a ``timeout=``
    recovers it).
  * ``corrupt_exec_frame(widx, nth)`` — flip a payload byte of the
    n-th exec frame to worker ``widx`` after its CRC is computed; the
    worker detects :class:`~repro_torch.core.errors.RingCorruption` and
    exits, and the supervisor respawns it.
  * ``ignore_sigterm`` — workers install SIG_IGN for SIGTERM, forcing
    the shutdown escalation path all the way to SIGKILL.

Everything is counter-based, not time-based, so a plan replays the
same failure sequence on any machine. :meth:`seeded_kills` derives a
reproducible random plan from a seed — the chaos soak tests sweep
seeds, and a failing seed is a one-line repro.

The parent-side hooks (`on_task_shipped`, `on_iter_broadcast`,
`on_done_frame`, `exec_frame_corrupt`) mutate plan state and are only
ever called from the driver's submit path and reaper thread; the
worker-side piece (`worker_stalls`) is a plain picklable list shipped
at spawn.

The port adds the bodies the chaos suite runs (`pingpong_step` and the
fault bodies below), which the reference keeps in its test file: a
worker starts from the fork server, which preloads this module, so a
body defined here costs a fresh worker no import, while one defined in
a test file would make the worker import the test module on its first
task. `pingpong_step` takes a shared-memory name or a
:class:`~repro_torch.core.procs.apps.DeviceName`.
"""
from __future__ import annotations

import os
import random
import signal
import time
from typing import Dict, List, Optional, Tuple, Union

from .apps import DeviceName, _attach, spin


class FaultPlan:
    """A deterministic, seeded script of injected failures."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.ignore_sigterm = False
        self._kills: List[List] = []         # [after_tasks, widx, done]
        self._iter_kills: List[List] = []    # [nth_iter, widx, done]
        self._stalls: List[Tuple[str, float, int]] = []
        self._done_actions: Dict[int, List[List]] = {}  # widx -> [[nth,
        #                                       action, arg, done], ...]
        self._corrupt: Dict[int, List[int]] = {}   # widx -> [nth, ...]
        self._shipped = 0
        self._iters = 0
        self._done_seen: Dict[int, int] = {}
        self._exec_seen: Dict[int, int] = {}

    # -- authoring ------------------------------------------------------
    def kill_worker(self, widx: int, after_tasks: int) -> "FaultPlan":
        if after_tasks < 1:
            raise ValueError("after_tasks must be >= 1")
        self._kills.append([after_tasks, widx, False])
        self._kills.sort(key=lambda e: e[0])
        return self

    def kill_worker_at_iter(self, widx: int, nth_iter: int = 1
                            ) -> "FaultPlan":
        if nth_iter < 1:
            raise ValueError("nth_iter must be >= 1")
        self._iter_kills.append([nth_iter, widx, False])
        return self

    def stall_body(self, label_contains: str, stall_s: float,
                   times: int = 1) -> "FaultPlan":
        self._stalls.append((label_contains, stall_s, times))
        return self

    def drop_done(self, widx: int, nth: int = 1) -> "FaultPlan":
        self._done_actions.setdefault(widx, []).append(
            [nth, "drop", 0.0, False])
        return self

    def delay_done(self, widx: int, nth: int = 1,
                   delay_s: float = 0.01) -> "FaultPlan":
        self._done_actions.setdefault(widx, []).append(
            [nth, "delay", delay_s, False])
        return self

    def corrupt_exec_frame(self, widx: int, nth: int = 1) -> "FaultPlan":
        self._corrupt.setdefault(widx, []).append(nth)
        return self

    @classmethod
    def seeded_kills(cls, seed: int, num_workers: int, total_tasks: int,
                     kills: int = 2) -> "FaultPlan":
        """A reproducible random plan: ``kills`` worker kills at
        distinct points of a ``total_tasks``-task run."""
        plan = cls(seed)
        rng = random.Random(seed)
        hi = max(2, total_tasks)
        points = rng.sample(range(1, hi), min(kills, hi - 1))
        for after in sorted(points):
            plan.kill_worker(rng.randrange(num_workers), after)
        return plan

    # -- driver hooks (parent side) -------------------------------------
    def on_task_shipped(self, count: int = 1) -> List[int]:
        """Advance the shipped-task counter; return worker indices whose
        kill threshold was crossed by this ship."""
        self._shipped += count
        fire = []
        for entry in self._kills:
            if not entry[2] and entry[0] <= self._shipped:
                entry[2] = True
                fire.append(entry[1])
        return fire

    def on_iter_broadcast(self) -> List[int]:
        """Advance the plane-iteration counter; return worker indices
        to kill after this ITER broadcast."""
        self._iters += 1
        fire = []
        for entry in self._iter_kills:
            if not entry[2] and entry[0] == self._iters:
                entry[2] = True
                fire.append(entry[1])
        return fire

    def on_done_frame(self, widx: int
                      ) -> Optional[Union[str, Tuple[str, float]]]:
        """Called per done frame popped from worker ``widx``; returns
        None, ``"drop"``, or ``("delay", seconds)``."""
        acts = self._done_actions.get(widx)
        if not acts:
            return None
        nth = self._done_seen[widx] = self._done_seen.get(widx, 0) + 1
        for entry in acts:
            if not entry[3] and entry[0] == nth:
                entry[3] = True
                return entry[1] if entry[1] == "drop" \
                    else (entry[1], entry[2])
        return None

    def exec_frame_corrupt(self, widx: int) -> bool:
        """Called per exec frame shipped to worker ``widx``; True means
        corrupt this frame's payload post-CRC."""
        nths = self._corrupt.get(widx)
        if not nths:
            return False
        nth = self._exec_seen[widx] = self._exec_seen.get(widx, 0) + 1
        return nth in nths

    # -- worker side ----------------------------------------------------
    def worker_stalls(self) -> List[Tuple[str, float, int]]:
        """The picklable stall spec shipped to every worker at spawn."""
        return list(self._stalls)


# ---------------------------------------------------------------------------
# the chaos suite's bodies
#
# Idempotent ping-pong stencil: generation g reads buffer g%2 and assigns
# (never accumulates into) its own cell of buffer (g+1)%2, so a
# re-executed body recomputes the identical value from inputs that the
# dependence edges pin in place until every reader finished — the
# at-least-once retry contract. Regions key the PHYSICAL cells (buffer
# index, i), so the generation-(g+2) writer of the same cell carries
# WAW/WAR edges behind generation-g's write and its readers.

def pingpong_step(n0, n1, n: int, g: int, i: int,
                  spin_us: float = 0.0) -> None:
    bufs = (_attach(n0), _attach(n1))
    if spin_us:
        spin(spin_us)
    src, dst = bufs[g % 2], bufs[(g + 1) % 2]
    lo, hi = (i - 1) % n, (i + 1) % n
    if isinstance(n0, DeviceName):       # one-element slices: tensor ops
        dst[i:i + 1] = (src[lo:lo + 1] + src[i:i + 1]
                        + src[hi:hi + 1]) * 0.5 + 1.0
    else:
        dst[i] = (src[lo] + src[i] + src[hi]) * 0.5 + 1.0


def pingpong_deps(n: int, g: int, i: int) -> List[tuple]:
    return [(("cell", (g + 1) % 2, i), "inout"),
            (("cell", g % 2, (i - 1) % n), "in"),
            (("cell", g % 2, i), "in"),
            (("cell", g % 2, (i + 1) % n), "in")]


def submit_pingpong(rt, n0, n1, n: int, g0: int, stages: int,
                    retries: int = 0, timeout: Optional[float] = None,
                    spin_us: float = 0.0) -> List[tuple]:
    """Submit ``stages`` generations from ``g0``; returns the (func,
    args, deps, label) tuples, as the ``apps.submit_*`` functions do."""
    calls = []
    for g in range(g0, g0 + stages):
        for i in range(n):
            args = (n0, n1, n, g, i, spin_us)
            deps = pingpong_deps(n, g, i)
            calls.append((pingpong_step, args, deps, f"pp[{g},{i}]"))
            rt.task(pingpong_step, *args, deps=deps, label=f"pp[{g},{i}]",
                    retries=retries, timeout=timeout)
    return calls


def write_index(out_name: str, i: int) -> None:
    _attach(out_name)[i] = i + 1.0


def fail_once(flag_name: str, out_name: str, i: int) -> None:
    """Raises on its first run for ``i`` (flag set), writes on the next."""
    F, O = _attach(flag_name), _attach(out_name)
    if F[i] == 0.0:
        F[i] = 1.0
        raise RuntimeError("transient failure")
    O[i] = i + 1.0


def stall_once_then_write(flag_name: str, out_name: str, i: int,
                          stall_s: float = 5.0) -> None:
    """Wedges its first run for ``i`` past any short ``timeout=``."""
    F, O = _attach(flag_name), _attach(out_name)
    if F[i] == 0.0:
        F[i] = 1.0
        time.sleep(stall_s)
    O[i] = i + 1.0


def always_fails(message: str = "permanent failure") -> None:
    raise ValueError(message)


def kill_self() -> None:
    os.kill(os.getpid(), signal.SIGKILL)


def worker_probe(device: str = "cuda") -> dict:
    """The worker's pid and one small computation on ``device``: 1 + 4 +
    9 + 16 = 30.0 when the device works."""
    import torch
    x = torch.arange(1, 5, dtype=torch.float32, device=device)
    return {"pid": os.getpid(), "device": str(x.device),
            "value": float(x.square().sum().item())}
