"""Mixture-of-Experts with per-row sort-based capacity dispatch;
counterpart of `repro/models/moe.py` (`apply_moe` is `MoE.forward`).

Routing, sorting and packing happen independently per batch row, exactly
as in the JAX package, so the same tokens are kept and dropped:

* router logits in f32; padded experts (60 -> 64) masked to -1e30 before
  the softmax; renormalised top-k weights; Switch-style aux loss;
* a stable sort of each row's (token, choice) slots by expert, rank within
  the expert by a running count, capacity per (row, expert)
  `max(4, ceil4(S*k*cf/E_pad))`, overflow slots sent to a drop bin;
* three grouped matmuls through `kernels.ops.moe_gemm` over the E-major
  buffer [E_pad, B*cap, d] (differentiable: on CUDA the backward runs the
  dx and dw kernels, on the CPU autograd through the plain version);
* a combine in the activation dtype with `index_add_`, plus the shared
  experts as one gated MLP of width `num_shared_experts * moe_d_ff`.

The JAX version's sharding constraints (moe.py:118-166) stand at the
counterpart points (`constrain`, the identity unless the dry-run's mesh
is in scope): the packed buffer [B, E*C, d] (batch, and the slot dim on
model for big "ep" buffers), the E-major [E, B, C, d] form and the
grouped [E, B*C, d] operand and outputs of the three grouped matmuls
(experts on model under "ep", tokens on the data axes), the combine's
[B, E, C, d] and [B, E*C, d] forms, and the combined [B, S, d].

`MoE.forward` marks its host phases as profiler ranges (`core.trace.span`,
recorded only while a PyTorch profiler runs): `port.moe.route` (router
logits to the top-k weights and the aux loss), `port.moe.dispatch` (the
sort to the grouped operand) and `port.moe.combine` (the experts' output
to y, before the shared experts).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.trace import span
from ..kernels import ops as kops
from ..parallel.collectives import constrain, moe_mode
from .config import ModelConfig
from .layers import MLP, normal_param


def padded_experts(cfg: ModelConfig, multiple: int = 16) -> int:
    e = cfg.num_experts
    return ((e + multiple - 1) // multiple) * multiple


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    ep = padded_experts(cfg)
    c = int(tokens_per_group * cfg.experts_per_tok
            * cfg.capacity_factor / ep)
    return max(4, ((c + 3) // 4) * 4)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        d, f = cfg.d_model, cfg.moe_d_ff
        ep = padded_experts(cfg)
        dt = cfg.torch_dtype
        s = (2.0 / (d + f)) ** 0.5
        self.cfg = cfg
        self.router = normal_param((d, ep), 0.02, torch.float32, device, gen)
        self.w_gate = normal_param((ep, d, f), s, dt, device, gen)
        self.w_up = normal_param((ep, d, f), s, dt, device, gen)
        self.w_down = normal_param((ep, f, d), s, dt, device, gen)
        if cfg.num_shared_experts:
            self.shared = MLP(cfg, device, gen,
                              d_ff=f * cfg.num_shared_experts)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B,S,d] -> (y [B,S,d], aux_loss)."""
        cfg = self.cfg
        b, s, d = x.shape
        e_real, e_pad = cfg.num_experts, padded_experts(cfg)
        k = cfg.experts_per_tok
        cap = capacity(cfg, s)
        nk = s * k
        dev = x.device

        with span("port.moe.route"):
            logits = x.float() @ self.router                 # [B,S,E]
            if e_pad > e_real:
                logits[..., e_real:] = -1e30
            probs = torch.softmax(logits, dim=-1)
            top_w, top_i = torch.topk(probs, k, dim=-1)      # [B,S,k]
            top_w = top_w / top_w.sum(-1, keepdim=True)

            me = probs.mean(dim=(0, 1))
            ce = F.one_hot(top_i[..., 0], e_pad).float().mean(dim=(0, 1))
            aux = (me * ce).sum() * e_real

        # ---- per-row dispatch ------------------------------------------
        with span("port.moe.dispatch"):
            flat_e = top_i.reshape(b, nk)                    # expert per slot
            flat_t = torch.arange(s, device=dev).repeat_interleave(k)  # [nk]
            flat_w = top_w.reshape(b, nk)
            order = torch.argsort(flat_e, dim=1, stable=True)
            se = torch.gather(flat_e, 1, order)              # [B,nk]
            st = flat_t[order]                               # token idx
            sw = torch.gather(flat_w, 1, order)
            onehot = F.one_hot(se, e_pad)                    # [B,nk,E]
            rank = torch.gather(onehot.cumsum(1), 2,
                                se[..., None])[..., 0] - 1
            keep = rank < cap
            slot = torch.where(keep, se * cap + rank,
                               torch.full_like(se, e_pad * cap))  # drop bin

            rows = torch.arange(b, device=dev)[:, None]
            buf = x.new_zeros((b, e_pad * cap + 1, d))
            buf[rows, slot] = x[rows, st]
            # the JAX version's layout choices: decode-sized buffers stay
            # replicated; the slot dim goes on model only for big "ep"
            # buffers
            decode = s == 1 and b * e_pad * cap * d < (1 << 26)
            slot_ax = "model" if (moe_mode() == "ep" and not decode
                                  and e_pad * cap >= 4096) else None
            batch_ax = None if decode else "dp"
            e_ax = "model" if moe_mode() == "ep" else None
            tok_ax = None if decode else "dp"
            packed = constrain(buf[:, :-1], batch_ax, slot_ax, None)
            grouped4 = constrain(
                packed.reshape(b, e_pad, cap, d).transpose(0, 1),
                e_ax, tok_ax, None, None)
            grouped = constrain(
                grouped4.reshape(e_pad, b * cap, d).contiguous(),
                e_ax, tok_ax, None)

        h = constrain(kops.moe_gemm(grouped, self.w_gate), e_ax, tok_ax, None)
        hu = constrain(kops.moe_gemm(grouped, self.w_up), e_ax, tok_ax, None)
        out = constrain(kops.moe_gemm((F.silu(h) * hu).contiguous(),
                                      self.w_down), e_ax, tok_ax, None)

        # ---- combine ---------------------------------------------------
        with span("port.moe.combine"):
            slot_back = None if decode else e_ax
            out4 = constrain(out.reshape(e_pad, b, cap, d), e_ax, tok_ax,
                             None, None)
            outb = constrain(out4.transpose(0, 1), batch_ax, slot_back,
                             None, None).reshape(b, e_pad * cap, d)
            outb = constrain(outb, "dp", slot_back, None)
            vals = outb[rows, torch.where(keep, slot,
                                          torch.zeros_like(slot))]
            vals = torch.where(keep[..., None], vals, torch.zeros_like(vals))
            vals = vals * sw[..., None].to(out.dtype)
            y = x.new_zeros((b * s, d))
            y.index_add_(0, (rows * s + st).reshape(-1),
                         vals.reshape(b * nk, d))
            y = constrain(y.reshape(b, s, d), "dp", None, None)

        if cfg.num_shared_experts:
            y = y + self.shared(x.reshape(b * s, d)).reshape(b, s, d)
        return y.to(x.dtype), aux
