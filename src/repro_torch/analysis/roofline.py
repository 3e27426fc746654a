"""Roofline terms for the port: the H100's peak rates, `RooflineTerms`,
`model_flops` and a step counter; counterpart of
`repro/analysis/roofline.py`.

The JAX file parses the post-SPMD HLO of a compiled step (its blocks,
symbol tables and while-loop trip counts) because XLA's `cost_analysis()`
counts a loop body once. A PyTorch step runs eagerly, so every loop trip
dispatches its own ops and nothing needs multiplying out: `StepCounter`,
a `TorchDispatchMode`, counts the ops as they run instead. It gathers,
per device:

  * dot flops, by `torch.utils.flop_counter`'s formulas (those of
    `FlopCounterMode`) for every op its registry knows: mm, addmm, bmm,
    baddbmm, convolution and the fused attention ops;
  * the HBM proxy of the JAX file's `_dot_flops_bytes`: operand plus
    result bytes of every mm, addmm, bmm, baddbmm and convolution;
  * collective result bytes by the JAX file's five kinds, from the
    `_c10d_functional` ops that DTensor emits (a kind with no op reads
    0; an all-to-all on a host mesh is sent as an all-gather, see
    `repro_torch.launch.dryrun`);
  * the peak bytes of the storages the step creates and that are alive at
    once (the dry-run's temp bytes).

On DTensors the counter returns `NotImplemented` for the DTensor-level op,
so DTensor runs its sharding propagation and the counter then sees each
device's local op and every collective, as `CommDebugMode` does. The
counts are therefore per device; `terms()` scales them by `devices`, as
`analyze_hlo` scales the per-device HLO. Over plain tensors (one device)
the counts are the step's own.

Terms (per device, seconds), on the H100's data-sheet rates:
  compute    = flops / bf16 dense tensor-core flop/s
  memory     = hbm_bytes / HBM bytes/s
  collective = collective bytes / NVLink bytes/s per direction

The rates are NVIDIA's H100 Tensor Core GPU data sheet's (dense, without
sparsity): bf16 tensor-core flop/s, f32 (CUDA core) flop/s, HBM bytes/s,
and NVLink bytes/s, the data sheet's total for both directions halved.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


class Peaks(NamedTuple):
    hbm_bps: float       # HBM bytes/s
    bf16_fps: float      # dense bf16 tensor-core flop/s
    f32_fps: float       # f32 CUDA-core flop/s
    link_bps: float      # NVLink bytes/s, one direction


# NVIDIA H100 Tensor Core GPU data sheet, dense rates. NVLink: SXM 900
# GB/s, PCIe and NVL 600 GB/s (their bridges), both directions together.
PEAKS: Dict[str, Peaks] = {
    "H100 SXM": Peaks(3.35e12, 989e12, 67e12, 450e9),
    "H100 PCIe": Peaks(2.0e12, 756e12, 51e12, 300e9),
    "H100 NVL": Peaks(3.9e12, 835e12, 60e12, 300e9),
}


def peaks_for(name: str) -> Tuple[str, Peaks]:
    """The data-sheet part a device name (`torch.cuda.get_device_name`,
    `nvidia-smi`) denotes, and its rates; the SXM part by default."""
    key = ("H100 PCIe" if "PCIe" in name else
           "H100 NVL" if "NVL" in name else "H100 SXM")
    return key, PEAKS[key]


PEAK_FLOPS = PEAKS["H100 SXM"].bf16_fps
HBM_BW = PEAKS["H100 SXM"].hbm_bps
LINK_BW = PEAKS["H100 SXM"].link_bps

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    coll_bytes: Dict[str, float]
    devices: int

    @property
    def total_coll(self) -> float:
        return sum(self.coll_bytes.values())

    def seconds(self) -> Dict[str, float]:
        """Per-device seconds of each term at the H100 SXM's rates."""
        return {
            "compute": self.flops / self.devices / PEAK_FLOPS,
            "memory": self.hbm_bytes / self.devices / HBM_BW,
            "collective": self.total_coll / self.devices / LINK_BW,
        }

    def dominant(self) -> str:
        s = self.seconds()
        return max(s, key=s.get)


# ------------------------------------------------------------ the counter
_aten = torch.ops.aten
# the two operands of each product (addmm's and baddbmm's added input is
# not one, as the JAX file counts a dot's lhs and rhs)
_DOT_OPERANDS = {_aten.mm: slice(0, 2), _aten.bmm: slice(0, 2),
                 _aten.convolution: slice(0, 2),
                 _aten.addmm: slice(1, 3), _aten.baddbmm: slice(1, 3)}
_c10d = torch.ops._c10d_functional
_COLL_KIND = {
    _c10d.all_gather_into_tensor: "all-gather",
    _c10d.all_gather_into_tensor_coalesced: "all-gather",
    _c10d.all_reduce: "all-reduce",
    _c10d.all_reduce_coalesced: "all-reduce",
    _c10d.reduce_scatter_tensor: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _c10d.all_to_all_single: "all-to-all",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


# DTensor's sharding propagation runs ops on fake tensors of the global
# shapes (an op's output metadata; a composite op's decomposition, to
# propagate through it). That is no device's work: the counter pauses there.
_PROPAGATION = ("propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached")


def _pause_in_propagation(counter: "StepCounter"):
    """Wrap DTensor's propagation entry points so that `counter` pauses
    inside them. Returns the undo."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    origs = {n: ShardingPropagator.__dict__.get(n) for n in _PROPAGATION}
    missing = [n for n, f in origs.items() if f is None]
    if missing:
        raise RuntimeError(f"ShardingPropagator lacks {missing}: the step "
                           f"counter cannot tell DTensor's propagation from "
                           f"the devices' ops in this PyTorch")

    def wrap(orig):
        def paused(prop, *args, **kwargs):
            counter.paused += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                counter.paused -= 1
        return paused

    for n, f in origs.items():
        setattr(ShardingPropagator, n, wrap(f))

    def undo():
        for n, f in origs.items():
            setattr(ShardingPropagator, n, f)
    return undo


class StepCounter(TorchDispatchMode):
    """Counts a step's work per device as it runs; `terms()` gives the
    totals over `devices`. Enter it inside the `FakeTensorMode` (if any) so
    that it sees each op before the fake tensors are made."""

    def __init__(self, devices: int = 1):
        super().__init__()
        self.devices = devices
        self.flops = 0
        self.dot_flops: Dict[str, int] = {}
        self.hbm_bytes = 0
        self.coll_bytes: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.coll_ops: Dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.paused = 0
        self._depth = 0

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, args, out) -> None:
        """Add each new storage among the outputs to the live bytes, and
        take it off when the storage is freed. An output on an input's
        storage (a view, an in-place op) is not new."""
        ins = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata in ins or st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n)

    def __enter__(self):
        if self._depth == 0:          # re-entered for each decomposition
            self._unpause = _pause_in_propagation(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._unpause()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused or isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if DTensor in types:
            return NotImplemented         # DTensor then runs its local ops
        if func is not torch.ops.prim.device.default:
            # a composite op (matmul under inference mode) is counted by
            # the ops it decomposes into, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            name = str(packet)
            self.dot_flops[name] = self.dot_flops.get(name, 0) + n
        operands = _DOT_OPERANDS.get(packet)
        if operands is not None:
            self.hbm_bytes += sum(_nbytes(a) for a in args[operands]) \
                + _nbytes(out)
        kind = _COLL_KIND.get(packet)
        if kind is not None:
            self.coll_bytes[kind] += _nbytes(out)
            self.coll_ops[kind] = self.coll_ops.get(kind, 0) + 1
        self._track((args, list(kwargs.values())), out)
        return out

    def terms(self) -> RooflineTerms:
        d = self.devices
        return RooflineTerms(flops=float(self.flops * d),
                             hbm_bytes=float(self.hbm_bytes * d),
                             coll_bytes={k: float(v * d) for k, v in
                                         self.coll_bytes.items()},
                             devices=d)


# ------------------------------------------------------- analytic check
def model_flops(cfg, shape) -> float:
    """6*N(active)*D for train, 2*N*D for inference."""
    n = cfg.active_param_count()
    d = shape.global_batch * (shape.seq_len if shape.kind in
                              ("train", "prefill") else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d
