"""Entry points the models call for each hot spot; counterpart of
`repro/kernels/ops.py`.

Routing follows the JAX package's rule (repro/kernels/ops.py). Attention
calls that decode (`kv_len` set) and cross-attention (S != T: Whisper's
decoder, S tokens against the encoder's frames) use the plain op on any
device, as they do in JAX. A full-sequence self-attention call (S == T >
1, no `kv_len`, causal or not: the decoder archs' layers, Whisper's
bidirectional encoder and its causal decoder) on CUDA goes through the
flash-attention kernels, forward and backward
(`flash_attention.flash_attention`); the kernel's start-aligned causal
mask is right only because only S == T calls reach it. The kernels would
take a non-causal S != T call, but routing cross-attention to them would
be a path the JAX package does not have, so it stays on the plain op. On
the CPU every call is the plain op, `ref.attention_ref`, differentiated
by autograd.
`moe_gemm`, `selective_scan` and `ssm_scan` launch their kernels for CUDA
tensors and run the plain versions for CPU tensors. `moe_gemm` and
`selective_scan` are differentiable on both devices: on CUDA their
backwards launch their backward kernels (`moe_gemm`'s dx and dw, the
selective scan's reverse walk and its second pass), on the CPU autograd
differentiates the plain versions. `ssm_scan`, which no model calls, has
no backward kernel and raises under autograd on CUDA. `mlstm_scan` and
`slstm_scan`, xLSTM's two recurrences over a sequence (a `lax.scan` in the
JAX package, no Pallas kernel), launch their kernels for CUDA tensors and
run the plain versions for CPU tensors, which autograd differentiates; on
CUDA under autograd their backwards launch the xLSTM backward kernels
(`xlstm_scan.mlstm_scan_bwd`, `slstm_scan_bwd`). The
JAX package's `REPRO_FORCE_*` switches have no counterpart: the device
decides.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import ref as _ref
from .flash_attention import flash_attention
from .moe_gemm import moe_gemm
from .ssm_scan import selective_scan, ssm_scan
from .xlstm_scan import mlstm_scan, slstm_scan

__all__ = ["attention", "mlstm_scan", "moe_gemm", "selective_scan",
           "slstm_scan", "ssm_scan"]


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
