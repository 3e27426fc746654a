"""The prefill driver: the program's `make_prefill_step` over one prompt
batch a call, one caller in a closed loop, each call timed from the call
to its logits synchronised. Prompts come from a pool made on the device
before the window, a fresh one each call.

Set-up makes the weights, runs one call to load every kernel and two
more (profiled in a traced run, their logits kept for the check and for
the rows the reference routes). The window keeps the logits of a sample
of its calls, drawn from the seed over all of them (reservoir sampling,
so no call is copied and the sample covers the whole window); after the
window the reference computes those calls again."""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.train.train_step import make_prefill_step

from port_bench import devtrace, harness, stats, traffic
from port_bench.reference import judge, model as reference
from port_bench.weights import make_weights

WARM = 3                     # set-up calls: one cold, two steady
PROFILED = 2                 # the steady ones, profiled in a traced run


class Prefiller:
    def __init__(self, ctx: harness.Ctx, step_factory=make_prefill_step):
        a, tr = ctx.arch, ctx.cell["traffic"]
        self.dev = torch.device(ctx.device)
        self.batch = tr["batch"]
        self.weights = make_weights(a, ctx.seed, self.dev)
        self.model, self.params = harness.load_program(
            a, self.weights, self.dev, train=False)
        self.step = step_factory(self.model)
        self.pool = traffic.token_pool(
            a.vocab_size, (tr["pool_calls"] + WARM) * self.batch,
            tr["seq_len"], ctx.seed, self.dev, tr["zipf_exponent"])
        self.calls = tr["pool_calls"]

    def prompts(self, i: int) -> torch.Tensor:
        """Call i's prompts; set-up calls are -1, -2, ... (the pool's
        last rows, never used in the window)."""
        j = i % self.calls if i >= 0 else self.calls + WARM + i
        return self.pool[j * self.batch:(j + 1) * self.batch]

    def call(self, i: int) -> torch.Tensor:
        with devtrace.span("pb.prefill_call"):
            logits = self.step(self.params, {"tokens": self.prompts(i)})
        with devtrace.span("pb.sync"):
            harness.sync(self.dev)
        return logits


def run(ctx: harness.Ctx) -> harness.Outcome:
    cell, dev, a = ctx.cell, torch.device(ctx.device), ctx.arch
    tr = cell["traffic"]
    ctx.mark("imports")
    p = Prefiller(ctx, make_prefill_step)
    ctx.mark("weights, model, prompts")
    p.call(-1)
    ctx.mark("first call")
    steady = [-2, -3]
    kept = {}
    prof = None
    if ctx.trace:
        prof = devtrace.profiled(
            lambda: kept.update({i: p.call(i) for i in steady}))
    else:
        for i in steady:
            p.call(i)
    setup_s = ctx.setup_s()
    ctx.mark("two steady calls")

    rng = np.random.default_rng([traffic.mix(ctx.seed, traffic.SAMPLE)])
    k = cell["check"]["calls"]
    sample = {}                       # call index -> logits
    lat = []
    start = time.perf_counter()
    deadline = start + ctx.seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        logits = p.call(i)
        end = time.perf_counter()
        lat.append(end - t0)
        if len(sample) < k:
            sample[i] = logits
        else:
            j = int(rng.integers(0, i + 1))
            if j < k:
                del sample[sorted(sample)[j]]
                sample[i] = logits
        logits = None
        i += 1
        if end >= deadline:
            break
    wall = end - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx.after_window()

    checked = sorted(sample) + (steady if ctx.trace else [])
    prompts = torch.cat([p.prompts(c) for c in checked])
    got = torch.cat([sample[c] for c in sorted(sample)]
                    + [kept[c] for c in steady if c in kept])
    del p, sample, kept
    harness.free(dev)
    t_ref = time.perf_counter()
    want, rows = reference_logits(ctx, prompts)
    errors = judge.row_errors(got, want)
    del want, got
    numbers = judge.prefill_numbers(errors)
    harness.log(f"reference and comparison: "
                f"{time.perf_counter() - t_ref:.3f} s")
    harness.log(f"window: {i} calls in {wall:.3f} s; calls checked "
                f"{checked}; readings {numbers}; row errors "
                f"{judge.row_error_quantiles(errors)}")
    record = None
    if ctx.trace:
        b = tr["batch"]
        first = (len(checked) - PROFILED) * b      # the profiled calls' rows
        record = {"arch": a, "cell": cell, "profile": prof,
                  "profiled_units": PROFILED,
                  "moe_rows": [{li: [sum(c) for c in
                                     zip(*r[first + u * b:first + (u + 1) * b])]
                                for li, r in rows.items()}
                               for u in range(PROFILED)],
                  "window": {"wall_s": wall, "steps": i,
                             "tokens": i * b * tr["seq_len"]}}
    tokens = i * tr["batch"] * tr["seq_len"]
    return harness.Outcome(
        attempted=i, failed=0,
        e2e={"prefill_tokens_per_s": stats.rate(tokens, wall),
             "prefill_p95_ms": 1e3 * stats.percentile(lat, 95),
             "setup_s": setup_s, "peak_mem_gib": peak / 2**30},
        checks=harness.verdict(numbers, cell["limits"]),
        memory_peak_bytes=peak, record=record, profile=prof)


def reference_logits(ctx: harness.Ctx, prompts: torch.Tensor,
                     precision: str = "f32"):
    """The reference's logits of `prompts` [n,S] on the weights made
    again from the seed, a few rows at a time; and the rows its expert
    layers keep, by layer, one list a prompt."""
    a = ctx.arch
    harness.free(prompts.device)
    w = make_weights(a, ctx.seed, prompts.device)
    per = ctx.cell["check"]["rows_at_once"]
    outs, rows = [], {}
    for r0 in range(0, prompts.shape[0], per):
        lg, r = reference.logits(a, w, prompts[r0:r0 + per], precision)
        outs.append(lg)
        for li, counts in r.items():
            rows.setdefault(li, []).extend(counts)
    del w
    return torch.cat(outs), rows
