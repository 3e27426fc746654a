"""Weight bridge: the JAX package's parameter pytree -> the port's modules.

The JAX tree (as numpy arrays) is nested dicts whose ``"layers"`` entry is
a tuple with one dict per pattern position, each leaf stacked over
repeats. Layer i of the port is position ``i % len(pattern)`` of repeat
``i // len(pattern)``, so leaf ``layers[pos]/a/b[r]`` becomes the port's
``layers.{r*len(pattern)+pos}.a.b``. Layouts are kept as they are (the
JAX ``x @ w`` layout, w [d_in, d_out]). Every leaf must find a parameter
and every parameter a leaf, with equal shapes; anything else raises. The
optimizer state's `m` and `v` and a gradient tree have the params'
structure and map the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                        # owned, writable, contiguous
    if a.dtype.name == "bfloat16":         # ml_dtypes bf16, as JAX exports
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def jax_state_dict(tree: Dict[str, Any], n_pattern: int
                   ) -> Dict[str, torch.Tensor]:
    """Flatten the JAX params tree to the port's ``state_dict`` names."""
    out: Dict[str, torch.Tensor] = {}
    for key, sub in tree.items():
        if key != "layers":
            for name, leaf in _leaves(sub, f"{key}."):
                out[name] = _to_tensor(leaf)
            continue
        if len(sub) != n_pattern:
            raise ValueError(f"JAX params have {len(sub)} pattern "
                             f"positions, the config {n_pattern}")
        for pos, stacked in enumerate(sub):
            for name, leaf in _leaves(stacked):
                for r in range(leaf.shape[0]):
                    out[f"layers.{r * n_pattern + pos}.{name}"] = \
                        _to_tensor(leaf[r])
    return out


def _matched(params: nn.Module, tree: Dict[str, Any], what: str
             ) -> Dict[str, torch.Tensor]:
    """`tree` under the port's parameter names, checked against `params`:
    raises on a missing or unused leaf and on a shape mismatch."""
    sd = jax_state_dict(tree, len(params.cfg.pattern))
    want = dict(params.named_parameters())
    missing = sorted(set(want) - set(sd))
    unused = sorted(set(sd) - set(want))
    if missing or unused:
        raise KeyError(f"JAX {what} do not match the port: missing "
                       f"{missing}, unused {unused}")
    for name, t in sd.items():
        if tuple(t.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: JAX shape {tuple(t.shape)}, port "
                             f"shape {tuple(want[name].shape)}")
    return sd


def load_jax_params(params: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy a JAX params tree (numpy leaves) into `params` in place,
    casting to each parameter's dtype and device. Raises on a missing or
    unused leaf and on a shape mismatch."""
    params.load_state_dict(_matched(params, tree, "params"), strict=True)
    return params


def jax_grads(params: nn.Module, tree: Dict[str, Any]
              ) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree (numpy leaves, the params' structure) as a dict
    keyed by the port's parameter names, with the same checks as
    `load_jax_params`; for comparing the port's gradients with JAX's."""
    return _matched(params, tree, "grads")


def load_jax_opt_state(params: nn.Module, opt: Dict[str, Any]
                       ) -> Dict[str, Any]:
    """The JAX optimizer state ``{"m", "v", "step"}`` (numpy leaves) as the
    port's (`train.optimizer.init_opt_state`): f32 `m` and `v` by
    parameter name on each parameter's device, and an int32 `step`.
    Raises as `load_jax_params` does."""
    dev = {n: p.device for n, p in params.named_parameters()}
    out: Dict[str, Any] = {}
    for key in ("m", "v"):
        sd = _matched(params, opt[key], f"opt state {key!r}")
        out[key] = {n: t.to(device=dev[n], dtype=torch.float32)
                    for n, t in sd.items()}
    out["step"] = torch.tensor(int(np.asarray(opt["step"])),
                               dtype=torch.int32,
                               device=next(params.parameters()).device)
    return out
