"""Entry points the models call for each hot spot; counterpart of
`repro/kernels/ops.py`.

Routing follows the JAX package's rule. Attention calls that decode
(`kv_len` set, or S != T) use the plain op on any device, as they do in
JAX. A full-sequence call (S == T > 1, no `kv_len`) on CUDA goes through
the flash-attention kernels, forward and backward
(`flash_attention.flash_attention`); the kernel's start-aligned causal
mask is right only because only S == T calls reach it. On the CPU every
call is the plain op, `ref.attention_ref`, differentiated by autograd.
`moe_gemm` launches its kernel for CUDA tensors and runs the plain version
for CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import ref as _ref
from .flash_attention import flash_attention
from .moe_gemm import moe_gemm

__all__ = ["attention", "moe_gemm"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, window: Optional[int] = None,
              kv_len: Union[None, int, torch.Tensor] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """GQA attention; see kernels.ref.attention_ref for the contract."""
    s = q.shape[1]
    if q.is_cuda and s > 1 and kv_len is None and s == k.shape[1]:
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    return _ref.attention_ref(q, k, v, causal=causal, window=window,
                              kv_len=kv_len, softcap=softcap)
