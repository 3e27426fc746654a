"""Batched serving steps; counterpart of `repro/serve/serve_step.py`, plus
`make_serve_step` (in the JAX package at `train/train_step.py`, here until
the training step is ported).

Prefill teacher-forces the prompt through the decode path, as in the JAX
package. Everything runs under `torch.inference_mode()`.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import torch

from ..models.layers import padded_vocab
from ..models.registry import ModelAPI


def make_serve_step(model: ModelAPI) -> Callable:
    """(params, cache, tokens [B], pos) -> (greedy tokens [B] int32,
    logits [B,V], cache)."""
    @torch.inference_mode()
    def serve_step(params: Any, cache: Any, tokens: torch.Tensor,
                   pos: Union[int, torch.Tensor]):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        return logits.argmax(dim=-1).to(torch.int32), logits, cache
    return serve_step


@torch.inference_mode()
def prefill_into_cache(model: ModelAPI, params: Any, cache: Any,
                       prompt: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """Teacher-force the prompt through the decode path to fill the cache.
    prompt [B, P] -> (f32 logits of the last position [B, V], cache)."""
    logits = torch.zeros((prompt.shape[0], padded_vocab(model.cfg)),
                         dtype=torch.float32, device=prompt.device)
    for t in range(prompt.shape[1]):
        lg, cache = model.decode_step(params, cache, prompt[:, t], t)
        logits = lg.float()
    return logits, cache


@torch.inference_mode()
def greedy_decode(model: ModelAPI, params: Any, prompt: torch.Tensor,
                  max_new: int, max_len: int) -> torch.Tensor:
    """prompt [B,P] -> generated tokens [B,max_new] int32 (greedy)."""
    p_len = prompt.shape[1]
    cache = model.init_cache(prompt.shape[0], max_len)
    logits, cache = prefill_into_cache(model, params, cache, prompt)
    tok = logits.argmax(dim=-1).to(torch.int32)
    toks = [tok]
    for t in range(max_new - 1):
        logits, cache = model.decode_step(params, cache, tok, p_len + t)
        tok = logits.argmax(dim=-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)[:, :max_new]
