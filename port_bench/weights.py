"""Random weights from the seed, made on the device in one draw a dtype.

Every leaf of a configuration is listed here by the program's parameter
name and shape (`leaf_specs`), so the same tensors go to the program and,
made again from the same seed, to the reference. One flat buffer a dtype
is filled by one `normal_` call on a `torch.Generator` on the device;
each leaf is a view of it, scaled as the program's own init scales it
(normal leaves) or set to the program's constant (norm scales 1, Mamba's
A from log(1..N), its D 1, its conv and dt biases 0). The attention
biases are drawn (0.02), not zero, so that the forward exercises them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from .arch import Arch
from .traffic import WEIGHTS, mix


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    f32: bool            # f32 whatever the model dtype
    init: str            # "normal" | "const" | "a_log"
    value: float         # the normal's scale or the constant


def _n(name, shape, scale, f32=False):
    return Leaf(name, tuple(shape), f32, "normal", scale)


def _c(name, shape, value, f32=False):
    return Leaf(name, tuple(shape), f32, "const", value)


def leaf_specs(a: Arch) -> List[Leaf]:
    d, v = a.d_model, a.vocab_padded
    out = [_n("embed.embedding", (v, d), 0.02)]
    if not a.raw.get("tie_embeddings"):
        out.append(_n("embed.unembed", (d, v), 0.02))
    for i, (mixer, ffn) in enumerate(a.layers):
        p = f"layers.{i}."
        out.append(_c(p + "norm_mixer.scale", (d,), 1.0))
        m = p + "mixer."
        if mixer == "attn":
            hd, nq, nkv = a.head_dim, a.num_heads, a.num_kv_heads
            s = d ** -0.5
            out += [_n(m + "wq", (d, nq * hd), s),
                    _n(m + "wk", (d, nkv * hd), s),
                    _n(m + "wv", (d, nkv * hd), s),
                    _n(m + "wo", (nq * hd, d), s)]
            if a.raw.get("qkv_bias"):
                out += [_n(m + "bq", (nq * hd,), 0.02),
                        _n(m + "bk", (nkv * hd,), 0.02),
                        _n(m + "bv", (nkv * hd,), 0.02)]
        elif mixer == "mamba":
            di, n, dr = a.d_inner, a.ssm_d_state, a.dt_rank
            s = d ** -0.5
            out += [_n(m + "in_proj", (d, 2 * di), s),
                    _n(m + "conv_w", (a.ssm_d_conv, di), 0.2),
                    _c(m + "conv_b", (di,), 0.0),
                    _n(m + "x_proj", (di, dr + 2 * n), s),
                    _n(m + "dt_proj", (dr, di), dr ** -0.5),
                    _c(m + "dt_bias", (di,), 0.0),
                    Leaf(m + "a_log", (di, n), True, "a_log", 0.0),
                    _c(m + "d", (di,), 1.0, f32=True),
                    _n(m + "out_proj", (di, d), s)]
        else:
            raise ValueError(f"mixer {mixer!r} has no leaves here")
        if ffn == "none":
            continue
        out.append(_c(p + "norm_ffn.scale", (d,), 1.0))
        f = p + "ffn."
        if ffn == "mlp":
            h = a.d_ff
            s = (2.0 / (d + h)) ** 0.5
            out += [_n(f + "w_gate", (d, h), s), _n(f + "w_up", (d, h), s),
                    _n(f + "w_down", (h, d), s)]
        elif ffn == "moe":
            e, h = a.experts_padded, a.moe_d_ff
            s = (2.0 / (d + h)) ** 0.5
            out += [_n(f + "router", (d, e), 0.02, f32=True),
                    _n(f + "w_gate", (e, d, h), s),
                    _n(f + "w_up", (e, d, h), s),
                    _n(f + "w_down", (e, h, d), s)]
            if a.num_shared_experts:
                hs = h * a.num_shared_experts
                ss = (2.0 / (d + hs)) ** 0.5
                out += [_n(f + "shared.w_gate", (d, hs), ss),
                        _n(f + "shared.w_up", (d, hs), ss),
                        _n(f + "shared.w_down", (hs, d), ss)]
        else:
            raise ValueError(f"ffn {ffn!r} has no leaves here")
    out.append(_c("final_norm.scale", (d,), 1.0))
    return out


def make_weights(a: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf, by name: views of one flat buffer a dtype, drawn from
    the run's seed on `device`."""
    specs = leaf_specs(a)
    model_dtype = getattr(torch, a.dtype)
    gen = torch.Generator(device).manual_seed(mix(seed, WEIGHTS))
    out: Dict[str, torch.Tensor] = {}
    for f32 in (False, True):
        dtype = torch.float32 if f32 else model_dtype
        group = [s for s in specs if s.f32 == f32]
        sizes = [math.prod(s.shape) for s in group]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        flat.normal_(generator=gen)
        for s, t in zip(group, flat.split(sizes)):
            t = t.view(s.shape)
            if s.init == "normal":
                t.mul_(s.value)
            elif s.init == "const":
                t.fill_(s.value)
            else:
                t.copy_(torch.log(torch.arange(
                    1, s.shape[1] + 1, dtype=torch.float32,
                    device=device)).expand(s.shape))
            out[s.name] = t
    return out
