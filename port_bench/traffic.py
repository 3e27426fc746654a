"""One generator for every traffic mix; a mix is the parameters in its
workload file (`workloads/<cell>.json`, key "traffic").

`SyntheticLM` copies the program's `train/data.py` generator (Zipf 1.1
over the most frequent ids, each odd position the even one before it
shifted by a fixed amount, labels the tokens moved one to the left), with
its random state drawn from (seed, step) so that any seed works, however
large. `token_pool` draws prefill prompts on the device in one call."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def mix(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose (weights, traffic, sampling) of a
    run's seed."""
    ss = np.random.SeedSequence([int(seed) % 2**128, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# the purposes `mix` separates
WEIGHTS, TRAFFIC, SAMPLE = 1, 2, 3


class SyntheticLM:
    """Batches of `batch` x `seq_len` tokens, the same for the same seed
    and step; `batch_at(step)` is what the program's `Prefetcher` calls."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int, zipf_exponent: float = 1.1,
                 top_ids: int = 4096):
        self.batch, self.seq_len, self.seed = batch, seq_len, seed
        self.top = min(vocab_size, top_ids)
        probs = 1.0 / np.arange(1, self.top + 1) ** zipf_exponent
        self._probs = probs / probs.sum()
        self._shift = int(np.random.default_rng(
            [mix(seed, TRAFFIC), 0]).integers(1, self.top))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([mix(self.seed, TRAFFIC), 1, step])
        tok = rng.choice(self.top, size=(self.batch, self.seq_len),
                         p=self._probs)
        tok[:, 1::2] = (tok[:, 0::2][:, :tok[:, 1::2].shape[1]]
                        + self._shift) % self.top
        labels = np.roll(tok, -1, axis=1)
        return {"tokens": tok.astype(np.int32),
                "labels": labels.astype(np.int32)}


def token_pool(vocab_size: int, count: int, seq_len: int, seed: int,
               device, zipf_exponent: float = 1.1) -> torch.Tensor:
    """[count, seq_len] int32 prompts, ids drawn by Zipf's law over the
    whole vocabulary (id r - 1 at rank r), on `device`."""
    gen = torch.Generator(device).manual_seed(mix(seed, TRAFFIC))
    probs = 1.0 / torch.arange(1, vocab_size + 1, device=device,
                               dtype=torch.float64) ** zipf_exponent
    ids = torch.multinomial(probs.float(), count * seq_len, replacement=True,
                            generator=gen)
    return ids.to(torch.int32).reshape(count, seq_len)
