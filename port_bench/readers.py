"""What the per-layer metrics' files share: each reads the record a traced
run hands over and returns a number, or None where it finds nothing to
read (a share of a roofline or a peak is never 0 for want of a kernel).

The record holds the configuration ("arch"), the cell, the card's
`peaks`, the profile of the sub-window ("profile", `devtrace.Profile`,
over `profiled_units` steps or calls), the rows the reference's expert
layers keep on those units' inputs ("moe_rows": one {layer: rows per
expert} a unit), the window ("window": wall_s, steps, tokens) and, for
training, the harness's host spans ("host").
"""
from __future__ import annotations

import statistics
from typing import Optional

import torch

from . import work
from .harness import log


def _itemsize(rec) -> int:
    dtype = getattr(torch, rec["arch"].dtype)
    return torch.empty((), dtype=dtype).element_size()


def device_seconds(rec, substring: str) -> tuple:
    """Seconds and count of the profiled device operations whose name
    holds `substring`."""
    t, n = 0.0, 0
    for name, s in rec["profile"].ops:
        if substring in name:
            t, n = t + s, n + 1
    return t, n


def roofline(name: str, bounds: list, kernel_s: float, launches: int,
             expected: int) -> Optional[float]:
    """The bounds' sum over the kernels' time, per cent; the launches the
    profiler recorded are logged beside the configuration's count."""
    if not kernel_s or not bounds:
        return None
    bound_s, by = work.add(bounds)
    if launches != expected:
        log(f"{name}: the profiler recorded {launches} launches, the "
            f"configuration makes {expected}")
    log(f"{name}: bound {bound_s * 1e3:.4f} ms ({by}) over "
        f"{kernel_s * 1e3:.4f} ms of kernels, {launches} launches")
    return 100.0 * bound_s / kernel_s


def moe_gemm(rec, backward: bool) -> Optional[float]:
    """The grouped GEMM's bound, on the rows the reference routes, over
    the time of the `moe_gemm*` kernels."""
    a, p = rec["arch"], rec["peaks"]
    size = _itemsize(rec)
    bounds = [b for unit in rec["moe_rows"] for rows in unit.values()
              for b in work.moe_layer(rows, a.d_model, a.moe_d_ff, size, p,
                                      backward)]
    t, n = device_seconds(rec, "moe_gemm")
    return roofline("moe_gemm", bounds, t, n, len(bounds))


def flash(rec, backward: bool) -> Optional[float]:
    """Attention's bound over its live causal pairs over the time of the
    `flash_*` kernels."""
    a, p, tr = rec["arch"], rec["peaks"], rec["cell"]["traffic"]
    size = _itemsize(rec)
    shape = (tr["batch"], tr["seq_len"], a.num_heads, a.num_kv_heads,
             a.head_dim, size, p)
    one = [work.attention_fwd(*shape)]
    if backward:
        one.append(work.attention_bwd(*shape))
    layers = a.count(mixer="attn") * rec["profiled_units"]
    t, n = device_seconds(rec, "flash_")
    # one forward launch a layer; the backward's launches are the
    # program's choice, so only the forward's count is expected
    fwd = device_seconds(rec, "flash_fwd")[1]
    return roofline("flash", one * layers, t, fwd, layers)


def sel_scan(rec) -> Optional[float]:
    """The selective scan's bound over the time of the `sel_scan*`
    kernels."""
    a, p, tr = rec["arch"], rec["peaks"], rec["cell"]["traffic"]
    calls = a.count(mixer="mamba") * rec["profiled_units"]
    one = work.selective_scan(tr["batch"], tr["seq_len"], a.d_inner,
                              a.ssm_d_state, _itemsize(rec), p)
    t, n = device_seconds(rec, "sel_scan")
    return roofline("sel_scan", [one] * calls, t, n, calls)


def mfu(rec, train: bool) -> Optional[float]:
    """Model flops (6 or 2 times the active parameters a token) of the
    window's tokens over its wall, against the dense bf16 peak."""
    w = rec["window"]
    flops = work.model_flops(rec["arch"].active_param_count(), w["tokens"],
                             train)
    return 100.0 * flops / w["wall_s"] / rec["peaks"].bf16_fps


def device_idle(rec) -> Optional[float]:
    prof = rec["profile"]
    if not prof.window_s or not prof.busy_s:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)


def host_mean_ms(rec, key: str) -> Optional[float]:
    spans = rec.get("host", {}).get(key)
    return 1e3 * statistics.fmean(spans) if spans else None
