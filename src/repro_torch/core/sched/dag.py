"""Copy of `repro/core/sched/dag.py`.

Shared DAG core of the scheduling subsystem.

Every scheduling layer in this runtime reasons about the same object — a
task DAG flattened to int-indexed successor arrays:

  * the *static* scheduler (``sched.static``) replays the DDAST manager's
    release discipline over a :class:`DagNode` list to order device-side
    work (train microbatches, serve admission);
  * the *dynamic* replay scheduler (``engine/replay.py`` +
    :class:`~repro_torch.core.sched.placement.CriticalPathPlacement`) computes
    bottom levels over a frozen :class:`~repro_torch.core.engine.replay.ReplayGraph`'s
    successor arrays to prioritize the longest remaining chain.

Before this module existed both layers duplicated the topology code
(name→index maps, successor lists, topological event loops); now the
successor-array construction, the bottom-level / critical-path
computation, and the list-schedule event loop exist exactly once.

All functions here operate on plain lists indexed by task id so they are
agnostic to where the DAG came from (``DagNode`` lists, frozen replay
graphs, anything with successor arrays).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


@dataclass
class DagNode:
    """A node in an abstract device task DAG."""
    name: Hashable
    cost: float = 1.0                      # relative cost (virtual µs)
    deps: Sequence[Hashable] = ()          # names of predecessor nodes
    kind: str = "compute"                  # compute | collective | io


def build_arrays(nodes: Sequence[DagNode]
                 ) -> Tuple[Dict[Hashable, int], List[List[int]], List[int]]:
    """Flatten a ``DagNode`` list to (name→index map, successor arrays,
    predecessor counts). Dependences on names outside ``nodes`` are
    ignored, matching the historical ``ddast_schedule`` behavior."""
    idx = {n.name: i for i, n in enumerate(nodes)}
    succs: List[List[int]] = [[] for _ in nodes]
    npreds = [0] * len(nodes)
    for i, n in enumerate(nodes):
        for p in n.deps:
            j = idx.get(p)
            if j is not None:
                succs[j].append(i)
                npreds[i] += 1
    return idx, succs, npreds


def bottom_levels(succs: Sequence[Sequence[int]],
                  costs: Optional[Sequence[float]] = None) -> List[float]:
    """Per-task bottom level: the task's cost plus the longest-cost path
    to any sink through ``succs`` — the classic critical-path priority
    (a task's bottom level is the minimum remaining makespan once it
    starts). Computed in one reverse-topological pass over the flat
    successor arrays; raises ``ValueError`` on a cycle.

    ``costs`` defaults to 1.0 per task (bottom level = longest remaining
    chain length), the fallback the replay scheduler uses before any
    execution times have been recorded."""
    n = len(succs)
    bl = ([max(float(c), 1e-9) for c in costs] if costs is not None
          else [1.0] * n)
    preds_of: List[List[int]] = [[] for _ in range(n)]
    outdeg = [0] * n
    for i, ss in enumerate(succs):
        outdeg[i] = len(ss)
        for s in ss:
            preds_of[s].append(i)
    stack = [i for i in range(n) if outdeg[i] == 0]
    seen = 0
    while stack:
        v = stack.pop()
        seen += 1
        for p in preds_of[v]:
            base = (max(float(costs[p]), 1e-9) if costs is not None
                    else 1.0)
            if base + bl[v] > bl[p]:
                bl[p] = base + bl[v]
            outdeg[p] -= 1
            if outdeg[p] == 0:
                stack.append(p)
    if seen != n:
        raise ValueError("bottom_levels: successor arrays contain a cycle")
    return bl


def quantize_bands(levels: Sequence[float],
                   max_bands: int) -> Tuple[List[int], int]:
    """Map bottom levels to discrete priority bands (0 = lowest). Bands
    are what make the two-lane ready deques lock-free: a band is one
    GIL-atomic ``deque``, so pushes never need a heap or a lock. With at
    most ``max_bands`` distinct levels the mapping is exact (the longest
    remaining chain is *always* started first); beyond that, levels are
    rank-quantized so adjacent priorities may share a band."""
    distinct = sorted(set(levels))
    nd = len(distinct)
    if nd == 0:
        return [], 0
    if nd <= max_bands:
        rank = {v: i for i, v in enumerate(distinct)}
        return [rank[v] for v in levels], nd
    rank = {v: (i * max_bands) // nd for i, v in enumerate(distinct)}
    return [rank[v] for v in levels], max_bands


def list_schedule(costs: Sequence[float], succs: Sequence[Sequence[int]],
                  npreds: Sequence[int], num_units: int) -> List[int]:
    """Deterministic list schedule with the DDAST manager's release
    discipline, over int task ids: ready tasks are popped LIFO
    (chain/depth-first locality — the MAX_OPS_THREAD same-queue
    affinity) onto the earliest-free unit, and successor release happens
    at producer *finish* events, i.e. tasks are discovered incrementally
    like the manager draining Done messages, never all at once. Returns
    the start order (a valid topological order of the reachable DAG)."""
    n = len(costs)
    ready: List[int] = [i for i in range(n) if npreds[i] == 0]
    unit_free = [0.0] * num_units
    pending = list(npreds)
    order: List[int] = []
    events: List[Tuple[float, int, int]] = []
    seqc = 0
    tcur = 0.0
    while ready or events:
        while ready:
            u = min(range(num_units), key=lambda i: unit_free[i])
            nm = ready.pop()                     # LIFO: chain locality
            start = max(unit_free[u], tcur)
            end = start + max(costs[nm], 1e-3)
            unit_free[u] = end
            heapq.heappush(events, (end, seqc, nm))
            seqc += 1
            order.append(nm)
        if events:
            tcur, _, nm = heapq.heappop(events)
            for s in succs[nm]:
                pending[s] -= 1
                if pending[s] == 0:
                    ready.append(s)
    return order
