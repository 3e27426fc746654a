"""Copy of `repro/core/depgraph.py`.

Task dependence graph (paper §2.2.1 / §3).

Region-based dependence tracking equivalent to Nanos++'s "regions" plugin
restricted to whole-region aliases (the granularity used by all three paper
benchmarks: one region per matrix block / particle block).

Per region the graph keeps the *last writer* and the *readers since the last
write*. Predecessor rules (classic task-dataflow):

  IN    dep -> predecessor is the last writer (RAW)
  OUT   dep -> predecessors are last writer (WAW) + readers since (WAR)
  INOUT dep -> both of the above

The graph is NOT internally synchronized. Callers serialize access:
 - sync (Nanos++-like) mode: a single spinlock around every graph operation;
 - ddast mode: manager threads, with per-worker Submit-queue exclusivity,
   are the only mutators (paper §3.1).

The graph also records instrumentation the paper plots (Figs 12-14): the
number of in-graph tasks over time and the high-water mark.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from .wd import DepMode, TaskState, WorkDescriptor


@dataclass
class _RegionState:
    last_writer: Optional[WorkDescriptor] = None
    readers: List[WorkDescriptor] = field(default_factory=list)


def collect_preds_and_register(regions: Dict[Any, _RegionState],
                               wd: WorkDescriptor, deps) -> set:
    """The RAW/WAW/WAR predecessor rules over a region-state map:
    collect `wd`'s predecessors from `deps` ((key, mode) pairs), then
    register `wd` as last-writer/reader. Shared by DependenceGraph
    (keys = regions) and shards.GraphShard (keys = (parent_id, region))
    so the dependence semantics live in exactly one place."""
    preds = set()
    for key, mode in deps:
        st = regions.get(key)
        if st is None:
            st = regions[key] = _RegionState()
        if mode.reads and st.last_writer is not None:
            preds.add(st.last_writer)
        if mode.writes:
            if st.last_writer is not None:
                preds.add(st.last_writer)
            preds.update(st.readers)
        # register wd on the region *after* collecting preds
        if mode.writes:
            st.last_writer = wd
            st.readers = []
        elif mode.reads:
            st.readers.append(wd)
    preds.discard(wd)
    return preds


def scrub_regions(regions: Dict[Any, _RegionState],
                  wd: WorkDescriptor, deps) -> None:
    """Remove a completed `wd` from the region records (shared by
    DependenceGraph and shards.GraphShard)."""
    for key, mode in deps:
        st = regions.get(key)
        if st is None:
            continue
        if st.last_writer is wd:
            st.last_writer = None
        if mode.reads and wd in st.readers:
            st.readers.remove(wd)
        if st.last_writer is None and not st.readers:
            del regions[key]


class DependenceGraph:
    """Graph of sibling tasks (one instance per parent WD, paper §2.2.1)."""

    def __init__(self) -> None:
        self._regions: Dict[Any, _RegionState] = {}
        self.in_graph: int = 0           # tasks submitted, not yet completed
        self.max_in_graph: int = 0
        self.total_submitted: int = 0
        self.total_edges: int = 0

    # ------------------------------------------------------------------
    def submit(self, wd: WorkDescriptor) -> bool:
        """Insert `wd`, computing predecessors from its deps.

        Returns True iff the task is immediately ready (no pending preds).
        Must be called in task-creation order for siblings (the Submit
        queue ordering invariant of §3.1).
        """
        preds: Set[WorkDescriptor] = collect_preds_and_register(
            self._regions, wd, wd.deps)
        live_preds = [p for p in preds
                      if p.state not in (TaskState.COMPLETED, TaskState.DELETED)]
        wd.num_predecessors = len(live_preds)
        for p in live_preds:
            p.successors.append(wd)
        self.total_edges += len(live_preds)
        self.in_graph += 1
        self.total_submitted += 1
        self.max_in_graph = max(self.max_in_graph, self.in_graph)
        wd.state = TaskState.SUBMITTED
        if wd.num_predecessors == 0:
            wd.mark_ready()
            return True
        return False

    # ------------------------------------------------------------------
    def complete(self, wd: WorkDescriptor) -> List[WorkDescriptor]:
        """Handle task finalization: remove `wd` from the graph, decrement
        successors, return the list of tasks that became ready."""
        newly_ready: List[WorkDescriptor] = []
        for succ in wd.successors:
            succ.num_predecessors -= 1
            if succ.num_predecessors == 0 and succ.state == TaskState.SUBMITTED:
                succ.mark_ready()
                newly_ready.append(succ)
        wd.successors = []
        # Scrub region records pointing at the completed task so the maps
        # do not grow without bound (region count is bounded by live data).
        scrub_regions(self._regions, wd, wd.deps)
        self.in_graph -= 1
        wd.mark_completed()
        return newly_ready
