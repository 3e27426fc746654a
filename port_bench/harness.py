"""What every run shares: finding a cell's files by name, building the
program's model on the benchmark's weights, the module guard, and the
result line.

A cell is its entry in `BENCHMARK.json` (configuration, traffic mix,
chips), its traffic mix `mixes/<traffic>.json` (the driver, the
traffic's parameters, the job's settings) and `workloads/<cell>.json`
(the limits of its comparison); its configuration is
`configs/<config>.json`; its driver `drivers/<driver>.py` (a `run(ctx)`);
each per-layer metric `metrics/<metric>.py` (a `read(rec)` that returns a
number or None). Which metrics a cell reports comes from `BENCHMARK.json`
beside this folder: its end-to-end metrics in `--trace 0` runs, its
per-layer metrics in `--trace 1` runs, each where its `workloads` list
names the cell (or everywhere without one).
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Optional

from .arch import Arch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _module(kind: str, name: str) -> ModuleType:
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell's entry in BENCHMARK.json, its traffic mix
    (`mixes/<traffic>.json`: the driver, the traffic's parameters and the
    job's settings) and its own file (`workloads/<cell>.json`: the
    limits of its comparison), merged."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = {}
    for kind, file in (("mixes", entry["traffic"]), ("workloads", name)):
        path = ROOT / kind / f"{file}.json"
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        cell.update(json.loads(path.read_text()))
    cell.update(name=name, config=entry["config"], chips=entry["chips"])
    return cell


def load_driver(name: str) -> ModuleType:
    return _module("drivers", name)


def load_metric(name: str) -> ModuleType:
    return _module("metrics", name)


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def metrics_of(cell: str, trace: bool, bench: Optional[dict] = None) -> list:
    """The entries of BENCHMARK.json's end-to-end (or per-layer) metrics
    that `cell` reports."""
    bench = bench or benchmark()
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------ program
def program_config(arch: Arch):
    """The program's `ModelConfig` from the file's fields."""
    import dataclasses
    from repro_torch.models.config import BlockSpec, ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in arch.raw.items() if k in names}
    kw["pattern"] = tuple(BlockSpec(mixer=m, ffn=f)
                          for m, f in arch.raw["pattern"])
    return ModelConfig(**kw)


def load_program(arch: Arch, weights: Dict, device, train: bool):
    """The program's model API and its parameter module on `device`, each
    parameter the benchmark's tensor itself (no copy). Raises if the
    program's leaves differ from the benchmark's in name, shape or
    dtype."""
    import torch
    from torch import nn
    from repro_torch.models.registry import get_model
    cfg = program_config(arch)
    params = get_model(cfg, "meta").init_params(None)
    if list(params.buffers()):
        raise RuntimeError("the program's model has buffers the benchmark "
                           "does not make")
    have = dict(params.named_parameters())
    if set(have) != set(weights):
        raise RuntimeError(f"leaves differ: program only "
                           f"{sorted(set(have) - set(weights))[:5]}, "
                           f"benchmark only "
                           f"{sorted(set(weights) - set(have))[:5]}")
    for name, t in weights.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name)
        old = mod._parameters[leaf]
        if old.shape != t.shape or old.dtype != t.dtype:
            raise RuntimeError(f"{name}: program {tuple(old.shape)} "
                               f"{old.dtype}, benchmark {tuple(t.shape)} "
                               f"{t.dtype}")
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=train)
    return get_model(cfg, torch.device(device)), params


# -------------------------------------------------------------------- runs
def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev) -> None:
    """Give back what nothing references any more."""
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def log(*parts) -> None:
    print("[port_bench]", *parts, file=sys.stderr, flush=True)


@dataclass
class Ctx:
    """One run: what the driver needs and what it hands back."""
    cell: dict
    arch: Arch
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = field(default_factory=time.perf_counter)   # process start
    after_window: Callable[[], None] = lambda: None         # the guard

    def setup_s(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self, what: str) -> None:
        """Log how far into the process `what` finished (where set-up
        goes)."""
        log(f"{self.setup_s():8.3f} s  {what}")


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]                 # end-to-end candidates by name
    checks: Dict[str, tuple]              # name -> (value, limit)
    memory_peak_bytes: int
    record: Optional[dict] = None         # what per-layer readers read
    profile: Optional[object] = None      # trace.Profile of the sub-window

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            v <= lim for v, lim in self.checks.values())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number the cell's limits name, beside its limit; raises if
    one of them was not computed."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise RuntimeError(f"no reading of {missing}")
    return {k: (float(numbers[k]), float(lim)) for k, lim in limits.items()}
