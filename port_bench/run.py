"""One run of one cell of the PyTorch and CUDA port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (no PYTHONPATH needed: the program's package
is `src/repro_torch`). One process: set-up (from its start to the
window's start, `setup_s`), the window of `--seconds`, the module guard,
the comparison with the plain reference, then each compared number
beside its limit as the last lines of standard error and the result as
the last line of standard output. `--trace 1` reports the cell's
per-layer metrics in place of its end-to-end ones. Exits 2 without a
result where the card is missing, 3 where a forbidden module was
loaded.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux: /proc), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def bootstrap() -> None:
    """The import path and the program's kernel caches of a run."""
    # the script's own folder is not a package root: its module names
    # (stats, traffic, ...) must not shadow others
    sys.path[:] = [REPO, os.path.join(REPO, "src")] + [
        p for p in sys.path[1:] if os.path.abspath(p) != HERE]
    # every kernel cache of the program at a fixed place in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(REPO, ".port_bench_cache", sub)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def report(out, cell: dict, trace: bool, bench: dict, kind: str, part: str,
           peaks, limit) -> dict:
    """The result line of a run's outcome: the cell's end-to-end metrics
    (or, traced, its per-layer ones as their readers find them), the
    device, the breakdown of a traced run, and last the compared numbers
    beside their limits."""
    from port_bench import harness
    metrics = {}
    for m in harness.metrics_of(cell["name"], trace, bench):
        if trace:
            value = harness.load_metric(m["name"]).read(
                dict(out.record, peaks=peaks))
            if value is None:
                harness.log(f"{m['name']}: nothing to read")
                continue
        else:
            value = out.e2e[m["name"]]
        metrics[m["name"]] = {"value": finite(value), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": int(out.memory_peak_bytes),
              "peaks": part, "power_limit_w": limit}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=out.profile.busy_s,
                      window_s=out.profile.window_s)
        result["breakdown"] = out.profile.breakdown()
    result["checks"] = {k: {"value": finite(v), "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from port_bench import harness
    from port_bench.arch import Arch

    bench = harness.benchmark()
    cell = harness.load_cell(args.workload, bench)
    arch = Arch.load(cell["config"])

    import torch
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{chips} CUDA device(s) needed; torch.cuda."
                    f"is_available() {torch.cuda.is_available()}, "
                    f"device_count {torch.cuda.device_count()}")
        return 2

    def guard():
        bad = harness.forbidden_modules()
        if bad:
            harness.log(f"forbidden modules loaded: {bad}")
            sys.exit(3)

    from port_bench.peaks import peaks_for
    kind = torch.cuda.get_device_name(0)
    part, peaks = peaks_for(kind)
    harness.log(f"{time.perf_counter() - T0:8.3f} s  torch, the card")
    ctx = harness.Ctx(cell=cell, arch=arch, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t0=T0, after_window=guard)
    out = harness.load_driver(cell["driver"]).run(ctx)
    guard()

    limit = power_limit_w()
    result = report(out, cell, bool(args.trace), bench, kind, part, peaks,
                    limit)
    harness.log(f"{kind}, power limit {limit} W; correct {out.correct}")
    for k, (v, lim) in out.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    bootstrap()
    sys.exit(main())
