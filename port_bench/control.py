"""The readings that a cell's limits are set from, at the cell's size:
for each seed the program's numbers against the reference (the lower
readings), and on some seeds the control's (the reference in float8 in
the program's place) and each planted fault's (the upper readings).
Training needs no window; a prefill reads the cell's first calls.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out FILE]

One JSON line a seed on standard output (and appended to --out). Not run
by the benchmark's own runs."""
import os
import sys

if __name__ == "__main__":        # the program's package and this one
    HERE = os.path.dirname(os.path.abspath(__file__))
    REPO = os.path.dirname(HERE)
    sys.path[:] = [REPO, os.path.join(REPO, "src")] + [
        p for p in sys.path[1:] if os.path.abspath(p) != HERE]

# the readings hold two sides' tensors at once: let the allocator grow
# its segments rather than fragment (the timed runs leave it as it is)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from port_bench import faults, harness  # noqa: E402
from port_bench.arch import Arch  # noqa: E402
from port_bench.reference import judge  # noqa: E402


def train_readings(ctx, control: bool, fault_names) -> dict:
    drv = harness.load_driver("train")

    def program(factory):
        t = drv.Trainer(ctx, factory)
        try:
            prog, _ = drv.program_setup(t, ctx)
        finally:
            t.close()
        del t
        harness.free(torch.device(ctx.device))
        return prog

    prog = program(drv.make_train_step)
    ref = drv.reference_readings(ctx)
    dev = torch.device(ctx.device)
    out = {"program": judge.train_numbers(prog, ref, dev),
           "program_detail": judge.train_detail(prog, ref),
           "losses": {"program": prog["losses"], "reference": ref["losses"]}}
    if control:
        ctl = drv.reference_readings(ctx, precision="fp8")
        out["control"] = judge.train_numbers(ctl, ref, dev)
        out["control_detail"] = judge.train_detail(ctl, ref)
    for name in fault_names:
        got = program(faults.TRAIN[name](drv.make_train_step))
        out[name] = judge.train_numbers(got, ref, dev)
        out[name + "_detail"] = judge.train_detail(got, ref)
    return out


def prefill_readings(ctx, control: bool, fault_names) -> dict:
    drv = harness.load_driver("prefill")
    calls = range(ctx.cell["check"]["calls"])
    dev = torch.device(ctx.device)

    def program(factory):
        p = drv.Prefiller(ctx, factory)
        p.call(-1)
        got = torch.cat([p.call(i) for i in calls])
        prompts = torch.cat([p.prompts(i) for i in calls])
        del p
        harness.free(dev)
        return got, prompts

    def read(name, got):
        err = judge.row_errors(got, want)
        out[name] = judge.prefill_numbers(err)
        out[name + "_quantiles"] = judge.row_error_quantiles(err)

    got, prompts = program(drv.make_prefill_step)
    want, _ = drv.reference_logits(ctx, prompts)
    out = {}
    read("program", got)
    del got
    if control:
        for name, precision in (("control", "fp8"), ("bf16_witness", "bf16")):
            ctl, _ = drv.reference_logits(ctx, prompts, precision)
            read(name, ctl)
            del ctl
    for name in fault_names:
        got, _ = program(faults.PREFILL[name](drv.make_prefill_step))
        read(name, got)
        del got
    return out


def readings(cell_name: str, seed: int, control: bool,
             with_faults: bool) -> dict:
    """One seed's readings of a cell: the program's numbers, and with
    `control` the control's (and, for a prefill, the bf16 witness's),
    with `with_faults` each planted fault's."""
    cell = harness.load_cell(cell_name)
    ctx = harness.Ctx(cell=cell, arch=Arch.load(cell["config"]), seed=seed,
                      seconds=0.0, trace=False)
    kind = cell["driver"]
    table = faults.TRAIN if kind == "train" else faults.PREFILL
    names = list(table) if with_faults else []
    if kind == "train":
        return train_readings(ctx, control, names)
    return prefill_readings(ctx, control, names)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None)
    ap.add_argument("--fault-seeds", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = set(int(s) for s in (args.control_seeds or "").split(",") if s) \
        if args.control_seeds is not None else set(seeds[:3])
    flt = set(int(s) for s in (args.fault_seeds or "").split(",") if s) \
        if args.fault_seeds is not None else set(seeds[:3])
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    for seed in seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed, seed in ctl, seed in flt)
        r.update(workload=args.workload, seed=seed,
                 seconds=time.perf_counter() - t0,
                 device=torch.cuda.get_device_name(0))
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
