"""A cell's set-up as its driver runs it, read through the program's own
spans and counters (`progtrace`) and the per-layer metrics on them.

    python3 port_bench/spans_probe.py --workload <cell> --seed <n> \\
        [--seconds <s>]

from the root of a checkout, on the card. The training cell: the
driver's `Trainer`, one step, two profiled steps, then a window of
`--seconds` in which the step clock and the runtime's idle polls are read
at its start and end. The prefill cell: the driver's `Prefiller`, one
call, two profiled calls. Prints one JSON line: the readings of the
`optimizer_*`, `step_offcpu_pct`, `rt_idle_polls` (training) or
`moe_dispatch_ms` (prefill) metric files, the share of the step's device
time launched inside the four `port.train.*` phases (the closure), the
idle time inside the harness's call span by the name each gap takes, each
`port.*` span's count, and `devtrace`'s own readings of the same window.
Exits 2 without a card.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def train(ctx, harness, progtrace, devtrace) -> dict:
    drv = harness.load_driver("train")
    t = drv.Trainer(ctx, drv.make_train_step)
    try:
        t.one()
        events = progtrace.profiled(
            lambda: [t.one() for _ in range(drv.PROFILED)])
        clock0 = t.step_fn.clock.read()
        polls0 = t.rt.idle_polls.total
        steps, start = 0, time.perf_counter()
        while time.perf_counter() - start < ctx.seconds:
            t.one()
            steps += 1
        clock1 = t.step_fn.clock.read()
        polls1 = t.rt.idle_polls.total
    finally:
        t.close()
    rec = {"profiled_units": drv.PROFILED, "window": {"steps": steps},
           "program_trace": progtrace.reduce(events),
           "counters": {"step_clock": [b - a for a, b in zip(clock0,
                                                               clock1)],
                        "idle_polls": polls1 - polls0}}
    out = readings(rec, harness, ("optimizer_device_ms.train",
                                  "optimizer_host_ms.train",
                                  "optimizer_launches.train",
                                  "step_offcpu_pct.train",
                                  "rt_idle_polls.train"))
    pt = rec["program_trace"]
    phases = progtrace.launched_in(pt, progtrace.STEP_PHASES)
    call = progtrace.launched_in(pt, ("pb.step_call",))
    out["closure"] = {"phases_s": phases[0], "step_call_s": call[0],
                      "share": phases[0] / call[0] if call[0] else None,
                      "launches": [phases[1], call[1]]}
    out["counters"] = rec["counters"]
    return dict(out, **shared(pt, events, devtrace, progtrace,
                              "pb.step_call"))


def prefill(ctx, harness, progtrace, devtrace) -> dict:
    drv = harness.load_driver("prefill")
    p = drv.Prefiller(ctx, drv.make_prefill_step)
    p.call(-1)
    events = progtrace.profiled(lambda: [p.call(i) for i in (-2, -3)])
    rec = {"profiled_units": drv.PROFILED,
           "program_trace": progtrace.reduce(events)}
    out = readings(rec, harness, ("moe_dispatch_ms.prefill",))
    return dict(out, **shared(rec["program_trace"], events, devtrace,
                              progtrace, "pb.prefill_call"))


def readings(rec, harness, names) -> dict:
    return {"metrics": {n: harness.load_metric(n).read(rec) for n in names}}


def shared(pt, events, devtrace, progtrace, call: str) -> dict:
    owners = progtrace.idle_owners(pt, call)
    idle = sum(owners.values())
    named = sum(s for n, s in owners.items()
                if n.startswith(progtrace.PROGRAM))
    counts = {}
    for name, _, _, _ in pt.spans:
        if name.startswith(progtrace.PROGRAM):
            counts[name] = counts.get(name, 0) + 1
    old = devtrace.reduce_events(events)
    return {"idle_in_call": {"s": idle, "named_by_port_share":
                             named / idle if idle else None,
                             "by_name": sorted(owners.items(),
                                               key=lambda kv: -kv[1])[:12]},
            "span_counts": counts,
            "breakdown": pt.profile.breakdown(),
            "window_s": pt.profile.window_s, "busy_s": pt.profile.busy_s,
            "devtrace": {"window_s": old.window_s, "busy_s": old.busy_s,
                         "gaps_top": old.breakdown()["idle_gaps"][:3]}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=32.0)
    args = ap.parse_args()
    # as run.py: the script's folder is not a package root
    sys.path[:] = [REPO, os.path.join(REPO, "src")] + [
        p for p in sys.path[1:] if os.path.abspath(p) != HERE]
    import torch
    from port_bench import devtrace, harness, progtrace
    from port_bench.arch import Arch
    if not torch.cuda.is_available():
        harness.log("a CUDA card is needed")
        return 2
    cell = harness.load_cell(args.workload)
    ctx = harness.Ctx(cell=cell, arch=Arch.load(cell["config"]),
                      seed=args.seed, seconds=args.seconds, trace=True)
    run = {"train": train, "prefill": prefill}[cell["driver"]]
    out = run(ctx, harness, progtrace, devtrace)
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
