"""Faults planted in the timed path, each a step factory in place of the
program's: the comparison must read each as not correct (the tests at a
small size, `control.py` at the cell's size)."""
from __future__ import annotations

import torch


def unchanged_state(make_train_step):
    """A training step that computes the loss and returns its state
    unchanged."""
    from repro_torch.train.train_step import make_loss_fn

    def factory(model, tcfg):
        loss_fn = make_loss_fn(model, tcfg)

        def step(params, opt, batch):
            with torch.no_grad():
                _, metrics = loss_fn(params, batch)
            return params, opt, metrics
        return step
    return factory


def half_batch(make_train_step):
    """A training step over the first half of each batch's rows, its mean
    taken over them."""
    def factory(model, tcfg):
        inner = make_train_step(model, tcfg)

        def step(params, opt, batch):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return inner(params, opt, half)
        return step
    return factory


def altered_answer(make_prefill_step):
    """A prefill whose answer comes out altered where it is produced:
    every position's logits moved one id along the vocabulary (a head
    whose id mapping is off by one). One altered position among a call's
    thousands is not seen: sound bf16 runs read single rows as far off."""
    def factory(model):
        inner = make_prefill_step(model)

        def step(params, batch):
            logits = inner(params, batch)
            with torch.inference_mode():
                logits.copy_(logits.roll(1, dims=-1))
            return logits
        return step
    return factory


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
PREFILL = {"altered_answer": altered_answer}
