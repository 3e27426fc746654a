"""A configuration file read into the shapes that the traffic, the
weights, the reference and the work arithmetic share; nothing here
imports the program.

The file (`configs/<name>.json`) holds the program's `ModelConfig` fields
at the top level, as they are run, beside `source`, `reduced`,
`deployment`, `departures` and `rms_norm_eps`. The derived sizes copy the
model's own rules (each named where it is defined): the vocabulary padded
to a multiple of 256, routed experts padded to a multiple of 16 with
their router logits masked, the capacity of a (row, expert) pair
`max(4, ceil4(int(S * k * cf / E_pad)))`, Mamba's dt rank `ceil(d / 16)`.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

ROOT = Path(__file__).resolve().parent


def _up(n: int, multiple: int) -> int:
    return (n + multiple - 1) // multiple * multiple


@dataclass(frozen=True)
class Arch:
    raw: dict

    @classmethod
    def load(cls, name: str) -> "Arch":
        return cls(json.loads((ROOT / "configs" / f"{name}.json").read_text()))

    def __getattr__(self, key):
        try:
            return self.raw[key]
        except KeyError:
            raise AttributeError(key) from None

    # -------------------------------------------------------------- shapes
    @property
    def layers(self) -> List[Tuple[str, str]]:
        """(mixer, ffn) of every layer: the period repeated."""
        return [tuple(b) for b in self.raw["pattern"]] * self.raw["repeats"]

    @property
    def head_dim(self) -> int:
        return self.raw.get("head_dim") or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:          # models/layers.py padded_vocab
        return _up(self.vocab_size, 256)

    @property
    def experts_padded(self) -> int:        # models/moe.py padded_experts
        return _up(self.num_experts, 16)

    def capacity(self, seq: int) -> int:    # models/moe.py capacity
        c = int(seq * self.experts_per_tok * self.capacity_factor
                / self.experts_padded)
        return max(4, _up(c, 4))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:               # models/ssm.py _dt_rank
        return max(1, math.ceil(self.d_model / 16))

    def count(self, mixer: str = None, ffn: str = None) -> int:
        return sum(1 for m, f in self.layers
                   if (mixer is None or m == mixer)
                   and (ffn is None or f == ffn))

    # ------------------------------------------------------- parameter counts
    def param_count(self) -> int:
        """`ModelConfig.param_count` of the program, copied: embedding,
        unembedding and every layer, for 6 N D and 2 N D."""
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        n = self.vocab_size * d * (1 if self.raw.get("tie_embeddings") else 2)
        for mixer, ffn in self.layers:
            if mixer in ("attn", "attn_local"):
                n += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
                if self.raw.get("qkv_bias"):
                    n += (nq + 2 * nkv) * hd
            elif mixer == "mamba":
                di, ns = self.d_inner, self.ssm_d_state
                n += (d * 2 * di + di * self.ssm_d_conv
                      + di * (2 * ns + 1) + di * d + di * ns)
            if ffn == "mlp":
                n += 3 * d * self.d_ff
            elif ffn == "moe":
                n += self.num_experts * 3 * d * self.moe_d_ff \
                    + d * self.num_experts
                n += self.num_shared_experts * 3 * d * self.moe_d_ff
        return n

    def active_param_count(self) -> int:
        """`ModelConfig.active_param_count`, copied: the routed experts a
        token reaches in place of all of them."""
        routed = 3 * self.d_model * self.moe_d_ff * self.count(ffn="moe")
        return (self.param_count() - routed * self.num_experts
                + routed * self.experts_per_tok)
