"""Fault tolerance & elasticity for 1000+-node runs: copy of
`repro/train/fault.py`.

Host-level machinery (works with any number of real hosts; exercised in
tests with simulated clocks):

* HeartbeatMonitor — per-host heartbeats; a host is DEAD after `timeout`,
  a STRAGGLER when its step latency exceeds `straggler_factor` x the
  cluster median (straggler mitigation = flag + plan around it).
* ElasticPlanner — given the surviving host set, proposes the largest
  valid (pod, data, model) mesh <= the original, plus the resharding plan
  (which checkpoint shards each new host loads). Recovery = restore from
  the newest checkpoint under the new mesh; the data pipeline is
  deterministic in `step`, so resume is exact.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class HostState:
    last_beat: float
    last_step: int = 0
    step_times: List[float] = field(default_factory=list)


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], timeout: float = 60.0,
                 straggler_factor: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        now = clock()
        self.hosts: Dict[str, HostState] = {
            h: HostState(last_beat=now) for h in hosts}

    def beat(self, host: str, step: int, step_time: float) -> None:
        st = self.hosts[host]
        st.last_beat = self.clock()
        st.last_step = step
        st.step_times.append(step_time)
        if len(st.step_times) > 20:
            st.step_times.pop(0)

    def dead(self) -> List[str]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.timeout]

    def stragglers(self) -> List[str]:
        med = self._median_step_time()
        if med is None:
            return []
        out = []
        for h, st in self.hosts.items():
            if st.step_times and \
                    st.step_times[-1] > self.straggler_factor * med:
                out.append(h)
        return out

    def _median_step_time(self) -> Optional[float]:
        times = sorted(st.step_times[-1] for st in self.hosts.values()
                       if st.step_times)
        if not times:
            return None
        return times[len(times) // 2]


@dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    hosts: List[str]
    note: str = ""


class ElasticPlanner:
    """Largest valid mesh from surviving hosts. Chips per host fixed;
    the model axis is preserved (TP degree is a property of the model
    layout), the data/pod axes shrink — so restored FSDP shards reshard
    only along the data axis (cheap all-gather plan)."""

    def __init__(self, chips_per_host: int = 4, model_axis: int = 16):
        self.chips_per_host = chips_per_host
        self.model_axis = model_axis

    def plan(self, alive_hosts: List[str],
             pods: Optional[int] = None) -> MeshPlan:
        chips = len(alive_hosts) * self.chips_per_host
        model = self.model_axis
        if chips < model:
            raise RuntimeError(
                f"{chips} chips cannot host a {model}-way model axis")
        data = chips // model
        # prefer a pod axis when the surviving set still spans pods
        if pods and pods > 1 and data % pods == 0:
            return MeshPlan(shape=(pods, data // pods, model),
                            axes=("pod", "data", "model"),
                            hosts=list(alive_hosts),
                            note=f"elastic: {chips} chips, {pods} pods")
        return MeshPlan(shape=(data, model), axes=("data", "model"),
                        hosts=list(alive_hosts),
                        note=f"elastic: {chips} chips, single pod")

    def reshard_plan(self, old_data: int, new_data: int
                     ) -> List[Tuple[int, List[int]]]:
        """Which old FSDP shards each new data-rank must read: contiguous
        block mapping old_data -> new_data (they divide in elastic steps)."""
        out = []
        for nd in range(new_data):
            lo = nd * old_data // new_data
            hi = (nd + 1) * old_data // new_data
            out.append((nd, list(range(lo, max(hi, lo + 1)))))
        return out
