"""Shared DAG core of the scheduling subsystem: copy of `DagNode`,
`build_arrays` and `bottom_levels` from `repro/core/sched/dag.py`, which
the serving engine uses to admit the longest request chain first.

Functions operate on plain lists indexed by task id.
"""
from __future__ import annotations

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
