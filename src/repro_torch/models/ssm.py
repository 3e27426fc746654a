"""State-space mixers; counterpart of `repro/models/ssm.py` for Mamba
(Jamba's SSM layers). `Mamba.forward` is `mamba_train`, the full-sequence
selective scan through `kernels.ops.selective_scan`, differentiable on
both devices (on CUDA through the scan's backward kernel, which keeps h
only at segment boundaries and never [B,S,D,N], as the JAX version's
chunked remat does); `Mamba.decode` is
`mamba_decode`, the one-step recurrence in plain ops, as in the JAX
package. Each mirrors its JAX function's dtypes as written: the forward's
causal conv adds shifted products in the activation dtype and its scan
forms dt * x in f32, while the decode takes the conv in f32 and forms
dt * x in the activation dtype, so the two agree exactly only in f32.

The decode state is batch-first, ``{"h": [B,di,N] f32, "conv": [B,K-1,di]}``,
and is updated in place, like the attention KV cache: the engine keeps
one cache for its whole life and zeroes a slot's lanes on admission.
xLSTM's mLSTM and sLSTM mixers are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import const_param, normal_param

State = Dict[str, torch.Tensor]


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d: x [B,S,D], w [K,D], by shifted adds in x's
    dtype (not `F.conv1d`, which sums in another order and, on the card,
    in TF32 through cuDNN)."""
    k, s = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi * w[i][None, None, :]
    return out + b[None, None, :]


class Mamba(nn.Module):
    """Mamba mixer: in_proj -> causal conv -> silu -> x_proj [dt_rank | N |
    N] -> selective scan, gated by silu(z) -> out_proj."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_expand * d
        n = cfg.ssm_d_state
        dr = _dt_rank(cfg)
        dt = cfg.torch_dtype
        s = (1.0 / d) ** 0.5
        self.cfg = cfg
        self.di, self.n, self.dr = di, n, dr
        self.in_proj = normal_param((d, 2 * di), s, dt, device, gen)
        self.conv_w = normal_param((cfg.ssm_d_conv, di), 0.2, dt, device, gen)
        self.conv_b = const_param((di,), 0.0, dt, device)
        self.x_proj = normal_param((di, dr + 2 * n), s, dt, device, gen)
        self.dt_proj = normal_param((dr, di), dr ** -0.5, dt, device, gen)
        self.dt_bias = const_param((di,), 0.0, dt, device)
        # a_log and d stay f32 whatever the model dtype, as in the JAX init
        self.a_log = nn.Parameter(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=device)).expand(di, n)
            .contiguous())
        self.d = const_param((di,), 1.0, torch.float32, device)
        self.out_proj = normal_param((di, d), s, dt, device, gen)

    def _dbc(self, xin: torch.Tensor):
        """x_proj, split into dt (after dt_proj and softplus), B and C."""
        dbc = xin @ self.x_proj
        dr, n = self.dr, self.n
        dt = F.softplus(dbc[..., :dr] @ self.dt_proj + self.dt_bias)
        return dt, dbc[..., dr:dr + n], dbc[..., dr + n:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """mamba_train: x [B,S,d] -> [B,S,d] through the selective scan
        (the kernel on CUDA; B and C go to it as strided column slices)."""
        xz = x @ self.in_proj
        xin, z = xz[..., :self.di], xz[..., self.di:]
        xin = F.silu(_causal_conv(xin, self.conv_w, self.conv_b))
        dt, bmat, cmat = self._dbc(xin)
        y, _ = kops.selective_scan(xin, dt, self.a_log, bmat, cmat, self.d)
        return (y * F.silu(z)) @ self.out_proj

    def decode(self, x: torch.Tensor, state: State,
               pos: Union[int, torch.Tensor, None] = None) -> torch.Tensor:
        """mamba_decode: x [B,1,d] -> [B,1,d]; `state` updated in place.
        `pos` is unused: the recurrence has no positions (it is taken so
        that every mixer's decode has one signature)."""
        xz = x[:, 0] @ self.in_proj
        xin, z = xz[..., :self.di], xz[..., self.di:]
        hist = torch.cat([state["conv"],
                          xin[:, None, :].to(state["conv"].dtype)], dim=1)
        conv = torch.einsum("bkd,kd->bd", hist.float(),
                            self.conv_w.float()) + self.conv_b
        xin = F.silu(conv).to(x.dtype)
        dt, bmat, cmat = self._dbc(xin)
        a = -torch.exp(self.a_log.float())
        da = torch.exp(dt.float()[..., None] * a[None])
        h = da * state["h"] + (dt * xin).float()[..., None] \
            * bmat.float()[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, cmat.float()) \
            + xin.float() * self.d[None]
        y = y.to(x.dtype) * F.silu(z)
        state["h"].copy_(h)
        state["conv"].copy_(hist[:, 1:])
        return (y @ self.out_proj)[:, None, :]


def init_mamba_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> State:
    di = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.ssm_d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, di),
                                dtype=cfg.torch_dtype, device=device)}
