"""The training driver: the program's `make_train_step` in a closed loop,
its host side as the program's trainer runs it (`launch/train.py`): a
`TaskRuntime` started beside the step, a `Prefetcher` on its dispatcher
fed by the benchmark's `SyntheticLM`, each batch copied to the device,
each step ending in its loss's read. No checkpoint is saved.

Set-up builds one trainer and drives it through the first three steps,
which the reference follows; the same trainer then runs the window. In a
traced run the second and third set-up steps are profiled and the window
runs as in any other run."""
from __future__ import annotations

import math
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.runtime import TaskRuntime
from repro_torch.train.data import Prefetcher
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step

from port_bench import devtrace, harness, traffic
from port_bench.reference import judge, model as reference
from port_bench.weights import make_weights

SETUP_STEPS = 3              # the steps the reference follows
PROFILED = 2                 # the last set-up steps a traced run profiles


def leaf_norms(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """Each leaf's norm(a - b), in f32."""
    with torch.no_grad():
        return {n: float((a[n].float() - b[n].float()).norm()) for n in a}


class Trainer:
    """The program's training step, its state and its host side."""

    def __init__(self, ctx: harness.Ctx,
                 step_factory: Callable = make_train_step):
        a, cell = ctx.arch, ctx.cell
        tr, host = cell["traffic"], cell["host"]
        self.dev = torch.device(ctx.device)
        self.weights = make_weights(a, ctx.seed, self.dev)
        self.model, self.params = harness.load_program(
            a, self.weights, self.dev, train=True)
        self.tcfg = TrainConfig(opt=OptConfig(**cell["optimizer"]),
                                aux_loss_weight=cell["loss"]["aux_weight"],
                                z_loss=cell["loss"]["z_weight"])
        self.step_fn = step_factory(self.model, self.tcfg)
        self.opt = init_opt_state(self.params)
        self.data = traffic.SyntheticLM(a.vocab_size, tr["batch"],
                                        tr["seq_len"], ctx.seed,
                                        tr["zipf_exponent"], tr["top_ids"])
        self.rt = TaskRuntime(num_workers=host["workers"], mode=host["mode"])
        self.prefetch = Prefetcher(self.data, self.rt.dispatcher,
                                   depth=host["prefetch_depth"])
        self.step = 0
        self.rt.start()

    def one(self):
        """One step as the trainer's loop runs it: (loss, seconds from the
        step call to its return, the time the loss was read)."""
        with devtrace.span("pb.prefetch_get"):
            host = self.prefetch.get(self.step)
        with devtrace.span("pb.to_device"):
            batch = {k: torch.from_numpy(v).to(self.dev)
                     for k, v in host.items()}
        t0 = time.perf_counter()
        with devtrace.span("pb.step_call"):
            self.params, self.opt, metrics = self.step_fn(
                self.params, self.opt, batch)
        t1 = time.perf_counter()
        with devtrace.span("pb.loss_read"):
            loss = float(metrics["loss"])
        self.step += 1
        return loss, t1 - t0, time.perf_counter()

    def close(self) -> None:
        self.rt.shutdown()


def sample_seed(ctx: harness.Ctx) -> int:
    return traffic.mix(ctx.seed, traffic.SAMPLE)


def program_setup(t: Trainer, ctx: harness.Ctx):
    """Drive the trainer through its set-up steps; return what they read:
    each step's loss, the step-1 gradient as the optimizer takes it (its
    first moment over 1 - b1): each leaf's norm of it and a sample of its
    elements; each leaf's change over the three steps; and the profile of
    the last two in a traced run."""
    rows = np.concatenate([t.data.batch_at(i)["tokens"]
                           for i in range(SETUP_STEPS)])
    if len(np.unique(rows, axis=0)) != len(rows):
        raise RuntimeError("two rows of the set-up steps are equal")
    losses = [t.one()[0]]
    ctx.mark("first step")
    b1 = t.tcfg.opt.b1
    grad_norms = {n: float(m.norm()) / (1 - b1)
                  for n, m in t.opt["m"].items()}
    grad1 = {n: v / (1 - b1) for n, v in
             judge.sample_leaves(t.opt["m"], sample_seed(ctx)).items()}
    ctx.mark("step-1 gradient sampled")
    profiled = PROFILED if ctx.trace else 0
    for _ in range(SETUP_STEPS - 1 - profiled):
        losses.append(t.one()[0])
    prof = None
    if profiled:
        prof = devtrace.profiled(lambda: [losses.append(t.one()[0])
                                          for _ in range(profiled)])
    ctx.mark(f"steps 2-{SETUP_STEPS}")
    p0 = make_weights(ctx.arch, ctx.seed, t.dev)
    update_norms = leaf_norms(dict(t.params.named_parameters()), p0)
    del p0
    ctx.mark("changes over the set-up steps")
    harness.log(f"set-up steps: losses {losses}")
    return {"losses": losses, "grad_norms": grad_norms, "grad1": grad1,
            "update_norms": update_norms}, prof


def reference_readings(ctx: harness.Ctx, precision: str = "f32") -> dict:
    """The reference's readings of the set-up steps on the same weights
    and batches, made again from the seed."""
    a, cell, dev = ctx.arch, ctx.cell, torch.device(ctx.device)
    tr = cell["traffic"]
    data = traffic.SyntheticLM(a.vocab_size, tr["batch"], tr["seq_len"],
                               ctx.seed, tr["zipf_exponent"], tr["top_ids"])
    p = make_weights(a, ctx.seed, dev)
    out = reference.train(a, p, [data.batch_at(i) for i in
                                 range(SETUP_STEPS)],
                          cell["optimizer"], cell["loss"]["aux_weight"],
                          cell["loss"]["z_weight"], precision=precision,
                          device=dev, sample_seed=sample_seed(ctx))
    p0 = make_weights(a, ctx.seed, dev)
    out["update_norms"] = leaf_norms(p, p0)
    del p, p0
    return out


def run(ctx: harness.Ctx) -> harness.Outcome:
    cell, dev = ctx.cell, torch.device(ctx.device)
    tr = cell["traffic"]
    tokens_per_step = tr["batch"] * tr["seq_len"]
    ctx.mark("imports")
    t = Trainer(ctx, make_train_step)
    ctx.mark("weights, model, optimizer state, runtime started")
    try:
        prog, prof = program_setup(t, ctx)
        setup_s = ctx.setup_s()
        enqueue, failed, steps = [], 0, 0
        start = time.perf_counter()
        deadline = start + ctx.seconds
        while True:
            loss, enq, end = t.one()
            steps += 1
            enqueue.append(enq)
            failed += not math.isfinite(loss)
            if end >= deadline:
                break
        wall = end - start
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0
        ctx.after_window()
    finally:
        t.close()
    del t
    harness.free(dev)
    t_ref = time.perf_counter()
    ref = reference_readings(ctx)
    numbers = judge.train_numbers(prog, ref, dev)
    harness.log(f"reference and comparison: "
                f"{time.perf_counter() - t_ref:.3f} s")
    harness.log(f"window: {steps} steps in {wall:.3f} s; readings "
                f"{numbers}; {judge.train_detail(prog, ref)}")
    record = None
    if ctx.trace:
        record = {"arch": ctx.arch, "cell": cell, "profile": prof,
                  "profiled_units": PROFILED,
                  "moe_rows": [{i: [sum(c) for c in zip(*r)]
                                for i, r in step.items()}
                               for step in ref["rows"][-PROFILED:]],
                  "window": {"wall_s": wall, "steps": steps,
                             "tokens": steps * tokens_per_step},
                  "host": {"step_call_s": enqueue}}
    return harness.Outcome(
        attempted=steps, failed=failed,
        e2e={"train_tokens_per_s": steps * tokens_per_step / wall,
             "setup_s": setup_s, "peak_mem_gib": peak / 2**30},
        checks=harness.verdict(numbers, cell["limits"]),
        memory_peak_bytes=peak, record=record, profile=prof)
