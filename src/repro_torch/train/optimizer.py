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
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch import nn

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


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Grads, opt: Dict[str, Any],
                 params: nn.Module
                 ) -> Tuple[nn.Module, Dict[str, Any], torch.Tensor]:
    """One AdamW step, in place on `params` and `opt`; returns them and
    the learning rate used."""
    opt["step"] += 1
    step = opt["step"].to(torch.float32)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
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
