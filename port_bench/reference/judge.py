"""The numbers that decide `correct`, each computed from the program's
readings and the reference's on the same inputs.

Training (the first three steps, driven through the window's own call):
  loss_gap         max over the steps of |loss - ref| / |ref|
  grad_norm_gap    the worst leaf's |norm(g) - norm(g_ref)| / max(norm(g_ref),
                   median leaf's norm(g_ref)), g the step-1 gradient as the
                   optimizer takes it (its first moment over 1 - b1)
  update_norm_gap  the same of each leaf's norm(p_3 - p_0), over the leaves
                   whose reference gradient is at least a thousandth of the
                   median leaf's (a key's bias under softmax gets a
                   gradient of round-off, which Adam makes a full step)
  grad_diff_median the median leaf's norm(g - g_ref) / norm(g_ref) of that
                   step-1 gradient, over the same elements of each leaf on
                   both sides (all of them, or 2**20 drawn from the seed):
                   norms average away the rounding of each element, so a
                   product in float8 leaves every norm above within a few
                   per cent; its elements show it
Prefill (the logits of calls sampled from the window), each row (position)
read by its relative error norm(l - l_ref) / norm(l_ref):
  logits_err_median  the median row's
  logits_err_max     the worst row's (a single altered answer shows here)
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List

import torch

GRAD_FLOOR = 1e-3


def worst(values: Iterable[float]) -> float:
    """The largest, or NaN if any is NaN (a NaN never passes a limit)."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def _worst_gap(got: Dict[str, float], want: Dict[str, float],
               names: List[str]) -> float:
    med = statistics.median(want[n] for n in want)
    return worst(abs(got[n] - want[n]) / max(want[n], med) for n in names)


SAMPLE = 1 << 20


def sample_leaves(leaves: Dict[str, torch.Tensor], seed: int
                  ) -> Dict[str, torch.Tensor]:
    """Each leaf's elements at indices drawn from `seed` (all of a leaf of
    at most SAMPLE elements), in f32 on the host: the same indices for
    the same seed, names and shapes."""
    out = {}
    for i, (n, t) in enumerate(sorted(leaves.items())):
        flat = t.detach().reshape(-1)
        if flat.numel() > SAMPLE:
            gen = torch.Generator(flat.device).manual_seed(seed + i)
            idx = torch.randint(flat.numel(), (SAMPLE,), generator=gen,
                                device=flat.device)
            flat = flat[idx]
        out[n] = flat.float().cpu()
    return out


def grad_diffs(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               device) -> Dict[str, float]:
    """Each leaf's norm(got - want) / norm(want), a leaf at a time on
    `device`."""
    out = {}
    for n, w in want.items():
        w = w.to(device).float()
        out[n] = float((got[n].to(device).float() - w).norm()
                       / w.norm().clamp(min=1e-30))
    return out


def train_numbers(prog: dict, ref: dict, device="cpu") -> Dict[str, float]:
    """`prog` and `ref` each hold "losses" (one a step), "grad_norms",
    "grad1" (the step-1 gradient, by leaf) and "update_norms"."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different steps")
    loss_gap = worst(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = [n for n in g if g[n] >= GRAD_FLOOR * med]
    diffs = grad_diffs(prog["grad1"], ref["grad1"], device)
    return {"loss_gap": loss_gap,
            "grad_norm_gap": _worst_gap(prog["grad_norms"], g, list(g)),
            "update_norm_gap": _worst_gap(prog["update_norms"],
                                          ref["update_norms"], moved),
            "grad_diff_median": statistics.median(diffs.values())}


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row of [..., V] logits: norm(got - want) / norm(want), in f32."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).flatten()


def prefill_numbers(errors: torch.Tensor) -> Dict[str, float]:
    """The row errors of every compared call, together."""
    errors = errors.float()
    if bool(torch.isnan(errors).any()):
        return {"logits_err_median": math.nan, "logits_err_max": math.nan}
    return {"logits_err_median": float(errors.median()),
            "logits_err_max": float(errors.max())}


def train_detail(prog: dict, ref: dict, top: int = 3) -> dict:
    """For the log: each step's loss gap, and the leaves that read the
    widest gaps of norms, with the median leaf's gap."""
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                         zip(prog["losses"], ref["losses"])]}
    for key in ("grad_norms", "update_norms"):
        want = ref[key]
        med = statistics.median(want.values())
        gaps = {n: abs(prog[key][n] - want[n]) / max(want[n], med)
                for n in want}
        ranked = sorted(gaps.items(), key=lambda kv: -kv[1])
        out[key] = {"worst": ranked[:top],
                    "median_leaf_gap": statistics.median(gaps.values())}
    return out


def row_error_quantiles(errors: torch.Tensor) -> Dict[str, float]:
    """For the log: quantiles of the row errors."""
    e = errors.float().cpu()
    q = torch.tensor([0.5, 0.9, 0.99, 0.999, 1.0])
    out = dict(zip(("p50", "p90", "p99", "p99.9", "max"),
                   torch.quantile(e, q).tolist()))
    out["worst_rows"] = torch.topk(e, min(5, e.numel())).indices.tolist()
    return out
