"""Train / prefill / serve step builders; counterpart of
`repro/train/train_step.py`.

Gradient accumulation over microbatches runs them in the DDAST static
schedule's discovery order (`core/sched`), as the JAX version's `lax.scan`
does; in eager PyTorch there is no collective to overlap on one card, so
the order only fixes the summation order. The accumulator is f32, or bf16
when `grad_compress` is set (train_step.py:70-96). Gradients come from
`torch.autograd.grad` over the module's parameters, by name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Union

import torch
import torch.nn.functional as F

from ..core.sched import DagNode, ddast_schedule
from ..models.registry import ModelAPI
from .optimizer import OptConfig, adamw_update, clip_by_global_norm

Batch = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    num_microbatches: int = 1
    aux_loss_weight: float = 0.01
    grad_compress: bool = False      # bf16 gradient accumulator
    z_loss: float = 1e-4


def microbatch_schedule(n: int) -> list:
    """DDAST-simulated order for n microbatch (fwd,bwd,reduce) chains —
    the static adaptation of the paper's manager."""
    nodes = []
    for i in range(n):
        nodes.append(DagNode(name=("fwd", i), cost=2.0))
        nodes.append(DagNode(name=("bwd", i), cost=4.0, deps=[("fwd", i)]))
        nodes.append(DagNode(name=("rs", i), cost=1.0, deps=[("bwd", i)],
                             kind="collective"))
    order = ddast_schedule(nodes, num_units=2)
    return [nm[1] for nm in order if nm[0] == "fwd"]


def make_loss_fn(model: ModelAPI, tcfg: TrainConfig) -> Callable:
    """(params, batch) -> (total, {"loss", "aux"}): mean NLL + aux_loss_weight
    · MoE aux + z_loss · mean(logsumexp²), in f32 (train_step.py:48-60)."""
    def loss_fn(params: Any, batch: Batch):
        logits, aux = model.forward(params, batch)
        lf = logits.float()
        lp = F.log_softmax(lf, dim=-1)
        labels = batch["labels"].long()
        nll = -torch.gather(lp, -1, labels[..., None])[..., 0]
        loss = nll.mean()
        # z-loss stabilizes the softmax normalizer at scale
        zl = torch.mean(torch.logsumexp(lf, dim=-1) ** 2)
        total = loss + tcfg.aux_loss_weight * aux + tcfg.z_loss * zl
        return total, {"loss": loss, "aux": aux}
    return loss_fn


def make_train_step(model: ModelAPI, tcfg: TrainConfig) -> Callable:
    """(params, opt, batch) -> (params, opt, metrics), params and opt
    updated in place; metrics hold device tensors (loss, aux, grad_norm,
    lr)."""
    loss_fn = make_loss_fn(model, tcfg)
    nmb = tcfg.num_microbatches

    def grad_fn(params, batch):
        names, plist = zip(*params.named_parameters())
        total, metrics = loss_fn(params, batch)
        # a parameter the loss does not reach (the embedding table when the
        # batch carries `embeds`) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(total, plist, materialize_grads=True)
        return dict(zip(names, grads)), metrics

    def train_step(params: Any, opt: Dict[str, Any], batch: Batch):
        if nmb <= 1:
            grads, metrics = grad_fn(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            acc_dtype = torch.bfloat16 if tcfg.grad_compress \
                else torch.float32
            g_acc = {n: torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for n, p in params.named_parameters()}
            lsum = 0.0
            for i in microbatch_schedule(nmb):    # DDAST discovery order
                mb = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])[i]
                      for k, v in batch.items()}
                g, m = grad_fn(params, mb)
                for n, a in g_acc.items():
                    a.add_(g[n].to(acc_dtype))
                lsum = lsum + m["loss"].detach()
            grads = {n: (a / nmb).float() for n, a in g_acc.items()}
            metrics = {"loss": lsum / nmb,
                       "aux": torch.zeros((), device=lsum.device)}
        grads, gnorm = clip_by_global_norm(grads, tcfg.opt.clip_norm)
        params, opt, lr = adamw_update(tcfg.opt, grads, opt, params)
        return params, opt, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def make_prefill_step(model: ModelAPI) -> Callable:
    """(params, batch) -> logits [B,S,V], without autograd."""
    @torch.inference_mode()
    def prefill_step(params: Any, batch: Batch):
        logits, _ = model.forward(params, batch)
        return logits
    return prefill_step


def make_serve_step(model: ModelAPI) -> Callable:
    """(params, cache, tokens [B], pos) -> (greedy tokens [B] int32,
    logits [B,V], cache)."""
    @torch.inference_mode()
    def serve_step(params: Any, cache: Any, tokens: torch.Tensor,
                   pos: Union[int, torch.Tensor]):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits.argmax(dim=-1).to(torch.int32), logits, cache
    return serve_step
