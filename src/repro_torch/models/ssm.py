"""State-space and recurrent mixers; counterpart of `repro/models/ssm.py`:
Mamba (Jamba's SSM layers) and xLSTM's mLSTM and sLSTM.
`Mamba.forward` is `mamba_train`, the full-sequence
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

`MLSTM.forward` and `SLSTM.forward` are `mlstm_train` and `slstm_train`:
the projections in the model dtype (the gates' `w_i`, `w_f` in f32), then
the recurrence over the whole sequence in f32 through `kernels.ops`
(`mlstm_scan`, `slstm_scan`: the kernels on CUDA, the plain versions,
differentiable, on the CPU). JAX wraps its `lax.scan` in a chunked
`jax.checkpoint` (`chunked_scan`, chunk 128), which saves memory in the
backward and does not change a forward result. Their `decode` is
`mlstm_decode` / `slstm_decode`, one step of `kernels.ref.mlstm_step` /
`slstm_step` in plain ops, as in the JAX package. Their states are
batch-first, all f32 and zero at the start (JAX's initial m is 0 too):
``{"c": [B,H,hd,hd], "n": [B,H,hd], "m": [B,H]}`` and ``{"c", "n", "h",
"m": [B,H,hd]}``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops as kops
from ..kernels.ref import mlstm_step, slstm_step
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


class MLSTM(nn.Module):
    """xLSTM's mLSTM mixer: q, k, v projections per head and scalar input
    and forget gates -> the matrix-memory recurrence -> out_proj."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        dt = cfg.torch_dtype
        s = (1.0 / d) ** 0.5
        self.h, self.hd = h, hd
        self.wq = normal_param((d, h * hd), s, dt, device, gen)
        self.wk = normal_param((d, h * hd), s, dt, device, gen)
        self.wv = normal_param((d, h * hd), s, dt, device, gen)
        # the gates stay f32 whatever the model dtype, as in the JAX init
        self.w_i = normal_param((d, h), s, torch.float32, device, gen)
        self.w_f = normal_param((d, h), s, torch.float32, device, gen)
        self.b_i = const_param((h,), 0.0, torch.float32, device)
        self.b_f = const_param((h,), 3.0, torch.float32, device)  # open
        self.out_proj = normal_param((h * hd, d), s, dt, device, gen)

    def _inputs(self, x: torch.Tensor):
        """x [..., d] -> q (scaled), k, v [..., H, hd] and i, f [..., H],
        all f32: the products in x's dtype, cast, then q scaled; the
        gates' products in f32."""
        shape = x.shape[:-1] + (self.h, self.hd)
        q = (x @ self.wq).reshape(shape).float() * self.hd ** -0.5
        k = (x @ self.wk).reshape(shape).float()
        v = (x @ self.wv).reshape(shape).float()
        xf = x.float()
        return q, k, v, xf @ self.w_i + self.b_i, xf @ self.w_f + self.b_f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """mlstm_train: x [B,S,d] -> [B,S,d]."""
        b, s, _ = x.shape
        y = kops.mlstm_scan(*self._inputs(x))
        return y.reshape(b, s, self.h * self.hd).to(x.dtype) @ self.out_proj

    def decode(self, x: torch.Tensor, state: State,
               pos: Union[int, torch.Tensor, None] = None) -> torch.Tensor:
        """mlstm_decode: x [B,1,d] -> [B,1,d]; `state` updated in place;
        `pos` unused (as in `Mamba.decode`)."""
        carry = (state["c"], state["n"], state["m"])
        (c, n, m), y = mlstm_step(carry, *self._inputs(x[:, 0]))
        for key, new in zip(("c", "n", "m"), (c, n, m)):
            state[key].copy_(new)
        y = y.reshape(x.shape[0], self.h * self.hd).to(x.dtype)
        return (y @ self.out_proj)[:, None]


class SLSTM(nn.Module):
    """xLSTM's sLSTM mixer: the i, f, z, o gates' input projections, then
    the scalar-memory recurrence with block-diagonal recurrent weights per
    head -> out_proj."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 gen: torch.Generator):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
        dt = cfg.torch_dtype
        s = (1.0 / d) ** 0.5
        self.h, self.hd = h, hd
        self.w_x = normal_param((d, 4 * h * hd), s, dt, device, gen)
        # recurrent weights and bias stay f32, as in the JAX init
        self.w_r = normal_param((4, h, hd, hd), hd ** -0.5, torch.float32,
                                device, gen)
        self.bias = const_param((4, h, hd), 0.0, torch.float32, device)
        self.out_proj = normal_param((h * hd, d), s, dt, device, gen)

    def _pre(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., d] -> the gates' input pre-activations [..., 4, H, hd]
        f32 (the product in x's dtype, then cast)."""
        return (x @ self.w_x).reshape(x.shape[:-1] + (4, self.h, self.hd)) \
            .float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """slstm_train: x [B,S,d] -> [B,S,d]."""
        b, s, _ = x.shape
        y = kops.slstm_scan(self._pre(x), self.w_r, self.bias)
        return y.reshape(b, s, self.h * self.hd).to(x.dtype) @ self.out_proj

    def decode(self, x: torch.Tensor, state: State,
               pos: Union[int, torch.Tensor, None] = None) -> torch.Tensor:
        """slstm_decode: x [B,1,d] -> [B,1,d]; `state` updated in place;
        `pos` unused."""
        keys = ("c", "n", "h", "m")
        carry, y = slstm_step(tuple(state[k] for k in keys),
                              self._pre(x[:, 0]), self.w_r, self.bias)
        for key, new in zip(keys, carry):
            state[key].copy_(new)
        y = y.reshape(x.shape[0], self.h * self.hd).to(x.dtype)
        return (y @ self.out_proj)[:, None]


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> State:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    return {"c": z((batch, h, hd, hd)), "n": z((batch, h, hd)),
            "m": z((batch, h))}


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> State:
    shape = (batch, cfg.num_heads, cfg.resolved_head_dim)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k in ("c", "n", "h", "m")}
