"""Copy of `repro/core/sched/static.py`.

DDAST as a *static* scheduler for device-side task DAGs.

On TPU, the compiled program cannot mutate a dependence graph at run time —
XLA fixes the schedule at compile time. The transferable part of the
paper's idea is the *order* the DDAST manager discovers tasks in: ready
tasks are released incrementally, keeping the working set ("in-graph"
tasks) minimal and interleaving producer completion with consumer release.

`ddast_schedule` replays the DDAST manager's release discipline in virtual
time over an arbitrary task DAG and returns a total order. The framework
uses it to:
  * order microbatch/collective nodes in the gradient-accumulation train
    step so the reduce-scatter of µbatch i overlaps compute of µbatch i+1
    (train/train_step.py);
  * order request admission in the serving engine's continuous batcher
    (serve/engine.py) — requests are tasks, prefill->decode are edges.

The topology machinery (successor arrays, the list-schedule event loop,
bottom levels) lives in :mod:`repro_torch.core.sched.dag`, shared with the
runtime's critical-path replay placement — this module only maps
names <-> int ids and keeps the historical API.
"""
from __future__ import annotations

from typing import Hashable, List, Optional, Sequence

from ..ddast import DDASTParams
from .dag import DagNode, build_arrays, list_schedule


def ddast_schedule(nodes: Sequence[DagNode], num_units: int = 2,
                   params: Optional[DDASTParams] = None) -> List[Hashable]:
    """Deterministic list schedule with the DDAST manager's release
    discipline (see :func:`~repro_torch.core.sched.dag.list_schedule`).
    Returns a valid topological order (asserted)."""
    params = params or DDASTParams()
    del params                          # tunables reserved, as historically
    _, succs, npreds = build_arrays(nodes)
    ids = list_schedule([n.cost for n in nodes], succs, npreds, num_units)
    order = [nodes[i].name for i in ids]

    pos = {nm: i for i, nm in enumerate(order)}
    for n in nodes:
        for p in n.deps:
            if p in pos:
                assert pos[p] < pos[n.name], "ddast_schedule violated a dep"
    assert len(order) == len(nodes), "DAG has a cycle or unknown dep"
    return order


def overlap_collectives(nodes: Sequence[DagNode],
                        order: List[Hashable]) -> List[Hashable]:
    """Post-pass: hoist every collective node to the earliest position the
    DAG allows (right after its latest-scheduled predecessor), maximizing
    the slack XLA's latency-hiding scheduler can use to overlap it with
    compute. Dependence-safe: a node never moves before a predecessor.

    A position map is maintained across moves (only the slice a move
    shifts is re-indexed), replacing the historical ``out.index(...)``
    scans that made this pass O(n²) in the collective count × DAG size."""
    deps = {n.name: set(n.deps) for n in nodes}
    out = list(order)
    pos = {nm: i for i, nm in enumerate(out)}
    for nm in [n.name for n in nodes if n.kind == "collective"]:
        i = pos[nm]
        # earliest legal slot: after the last predecessor in `out`
        pred_pos = [pos[p] for p in deps[nm]
                    if pos.get(p, len(out)) < i]
        lo = (max(pred_pos) + 1) if pred_pos else 0
        if lo < i:
            out.pop(i)
            out.insert(lo, nm)
            for k in range(lo, i + 1):
                pos[out[k]] = k
    # sanity: still topological
    for n in nodes:
        for p in n.deps:
            if p in pos:
                assert pos[p] < pos[n.name]
    return out
