"""AdamW + global-norm clipping + warmup-cosine schedule; counterpart of
`repro/train/optimizer.py`, as plain tensor code (not `torch.optim`).

Parameters are an `nn.Module`'s; gradients and the optimizer state are
dicts keyed by parameter name (`named_parameters()`), so they flatten to
checkpoints and bridge from JAX by name. The state is f32: `m` and `v`
per parameter and an int32 `step`. `adamw_update` does its math in f32
from the parameter's own dtype and casts back once, with the weight decay
inside the step, as the JAX version does (optimizer.py:65-73). It updates
the parameters and the state in place (JAX returns new trees), so a step
holds no second copy of either.

`ClipAndAdamW` is what a training step calls: the clip, then AdamW.
Where every tensor is on the CPU it runs `clip_by_global_norm` then
`adamw_update` as they are. Otherwise it runs them as two hand-written
kernels over all leaves (`kernels/adamw.py`): a deterministic squared
norm of every gradient, then one pass that clips each gradient and
updates p, m and v in place, with the same f32 arithmetic and the same
bf16 roundings as the plain loop; one launch of each for up to 4,000
leaves. p and g may each be bf16 or f32, with f32 `m` and `v` and the
step counter on the same card; a strided gradient is made contiguous,
and anything else the kernels cannot take (another dtype, strided p, m
or v, more than one device) raises. The schedule and the bias
corrections stay the PyTorch code below, and nothing waits for the card.
Its counters `fused_leaves` and `plain_leaves` count the leaves each path
updated.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.metrics import SlotCounter
from ..core.trace import span
from ..kernels import adamw as fused

Grads = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (a tensor): linear warmup, then cosine
    decay to `min_lr_frac` of the peak. f32, on step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: nn.Module) -> Dict[str, Any]:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    dev = next(params.parameters()).device
    return {"m": zeros,
            "v": {n: z.clone() for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: Grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def clip_by_global_norm(grads: Grads, max_norm: float
                        ) -> Tuple[Grads, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def _advance(cfg: OptConfig, opt: Dict[str, Any]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count the step; its learning rate and the two bias corrections, as
    f32 tensors on the step counter's device."""
    opt["step"] += 1
    step = opt["step"].to(torch.float32)
    return schedule(cfg, step), 1 - cfg.b1 ** step, 1 - cfg.b2 ** step


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Grads, opt: Dict[str, Any],
                 params: nn.Module
                 ) -> Tuple[nn.Module, Dict[str, Any], torch.Tensor]:
    """One AdamW step, in place on `params` and `opt`; returns them and
    the learning rate used."""
    lr, bc1, bc2 = _advance(cfg, opt)
    b1, b2 = cfg.b1, cfg.b2
    for name, p in params.named_parameters():
        gf = grads[name].float()
        m, v = opt["m"][name], opt["v"][name]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, opt, lr


class ClipAndAdamW:
    """A training step's clip and AdamW update: `(grads, opt, params) ->
    (params, opt, lr, grad_norm)`, in place on `params` and `opt`, the
    clip inside the `port.train.clip` span and the update inside
    `port.train.adamw`. Keeps the fused pass's tables for the set of
    leaves it saw last."""

    def __init__(self, cfg: OptConfig):
        self.cfg = cfg
        self.fused_leaves = SlotCounter(1)
        self.plain_leaves = SlotCounter(1)
        self._plan: Optional[fused.Plan] = None
        self._key: Optional[tuple] = None

    @torch.no_grad()
    def __call__(self, grads: Grads, opt: Dict[str, Any], params: nn.Module
                 ) -> Tuple[nn.Module, Dict[str, Any], torch.Tensor,
                            torch.Tensor]:
        cfg = self.cfg
        leaves = [(p, grads[n], opt["m"][n], opt["v"][n])
                  for n, p in params.named_parameters()]
        if fused.on_cpu(leaves, opt["step"]):
            with span("port.train.clip"):
                grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
            with span("port.train.adamw"):
                params, opt, lr = adamw_update(cfg, grads, opt, params)
            self.plain_leaves.add(0, len(leaves))
            return params, opt, lr, gnorm
        fused.check(leaves, opt["step"])
        key = fused.plan_key(leaves)
        if key != self._key:
            self._plan = fused.make_plan(
                leaves, fused.grid_blocks(leaves[0][0].device.index))
            self._key = key
        gs = [g.contiguous() for _, g, _, _ in leaves]
        with span("port.train.clip"):
            out = fused.norm(self._plan, gs, cfg.clip_norm)
        with span("port.train.adamw"):
            lr, bc1, bc2 = _advance(cfg, opt)
            fused.update(self._plan, gs, out, lr, bc1, bc2, cfg.b1, cfg.b2,
                         cfg.eps, cfg.weight_decay)
        self.fused_leaves.add(0, len(leaves))
        return params, opt, lr, out[0]
