"""Tiny configurations and cells for the harness's CPU tests: the two
cells' mixes and limits at a size a test run holds."""
from __future__ import annotations

import copy

from port_bench import harness
from port_bench.arch import Arch

MOE = {"name": "tiny-moe", "family": "moe", "d_model": 64, "num_heads": 4,
       "num_kv_heads": 4, "d_ff": 32, "vocab_size": 500,
       "pattern": [["attn", "moe"]], "repeats": 2, "qkv_bias": True,
       "rope_theta": 1e6, "num_experts": 6, "experts_per_tok": 2,
       "num_shared_experts": 2, "moe_d_ff": 32, "capacity_factor": 1.25,
       "rms_norm_eps": 1e-6, "dtype": "float32"}
HYBRID = {"name": "tiny-hybrid", "family": "hybrid", "d_model": 64,
          "num_heads": 4, "num_kv_heads": 2, "d_ff": 128, "vocab_size": 512,
          "pattern": [["mamba", "mlp"], ["mamba", "moe"], ["mamba", "mlp"],
                      ["mamba", "moe"], ["attn", "mlp"], ["mamba", "moe"],
                      ["mamba", "mlp"], ["mamba", "moe"]],
          "repeats": 1, "rope_theta": 1e4, "num_experts": 4,
          "experts_per_tok": 2, "num_shared_experts": 0, "moe_d_ff": 64,
          "capacity_factor": 1.25, "ssm_d_state": 16, "ssm_d_conv": 4,
          "ssm_expand": 2, "rms_norm_eps": 1e-6, "dtype": "float32"}
TRAIN = "qwen2moe-train-b4s2048"
PREFILL = "jamba-prefill-b1s4096"


def arch(kind: str, dtype: str = "float32") -> Arch:
    raw = copy.deepcopy(MOE if kind == TRAIN else HYBRID)
    raw["dtype"] = dtype
    return Arch(raw)


def cell(name: str) -> dict:
    """The benchmark's cell with its traffic cut to a tiny size."""
    c = harness.load_cell(name)
    if c["driver"] == "train":
        c["traffic"].update(batch=4, seq_len=32)
    else:
        c["traffic"].update(seq_len=64, pool_calls=8)
    return c


def ctx(name: str, seed: int = 2**31 + 7, seconds: float = 0.3,
        dtype: str = "float32", trace: bool = False) -> harness.Ctx:
    return harness.Ctx(cell=cell(name), arch=arch(name, dtype), seed=seed,
                       seconds=seconds, trace=trace, device="cpu")
