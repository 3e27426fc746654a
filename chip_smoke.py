#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the repository root on a machine with a Hopper card and `nvcc`.
Phases, in order; any failure raises and exits non-zero (no phase catches
its own failure):

  1. the card's name and power limit (nvidia-smi); TF32 off for f32;
  2. build the `moe_gemm` kernel from `src/repro_torch/kernels/csrc/` with
     nvcc for sm_90a, and print the build time and ptxas's report;
  3. the kernel against its plain PyTorch version on the card: the serving
     path's two shapes in bf16 and f32, a ragged shape, expert isolation;
     times (CUDA events, median after warm-up) of the kernel, the plain
     version and `torch.bmm`, beside the least time the card could take;
  4. the main path: `serve()` on full-width qwen2-moe-a2.7b with random
     bf16 weights from a seeded generator, with the kernel's launch count
     set to 0 just before and read just after;
  5. where a full-width decode step's time goes: host wall per step, then
     a torch.profiler window over the same steps for device busy time by
     kernel (device idle share = 1 - busy / wall);
  6. the tiny qwen2-moe engine in f32 on the card gives the same tokens as
     the port's greedy decode for each request;
  7. a JSON line with the kernel's numbers, then, last, the result line
     {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is visible.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.moe_gemm import moe_gemm  # noqa: E402
from repro_torch.kernels.ref import moe_gemm_ref  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.moe import capacity, padded_experts  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import greedy_decode  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
SLOTS, CLIENTS, REQUESTS, MAX_NEW = 4, 4, 16, 8

# NVIDIA data sheets, dense rates: memory bytes/s, bf16 tensor-core flop/s,
# f32 (CUDA core) flop/s. The SXM part is the default.
PEAKS = {"H100 SXM": (3.35e12, 989e12, 67e12),
         "H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12)}


def peaks_for(name: str):
    key = ("H100 PCIe" if "PCIe" in name else
           "H100 NVL" if "NVL" in name else "H100 SXM")
    return key, PEAKS[key]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of `fn` in ms, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(shapes, itemsize: int, flops_peak: float, bytes_peak: float):
    """Least ms for grouped matmuls of `shapes` (E,C,d,f): each input read
    once and the output written once at the memory rate, or the products
    at the peak rate, whichever is longer."""
    nbytes = sum((e * c * d + e * d * f + e * c * f) * itemsize
                 for e, c, d, f in shapes)
    flops = sum(2 * e * c * d * f for e, c, d, f in shapes)
    t_bytes, t_ops = nbytes / bytes_peak, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def profile_steps(cfg, per_step: int, n_steps: int = 8) -> None:
    """Full-width engine with all slots decoding: host wall per step
    without the profiler, then device busy time per step by kernel over
    the same number of steps under torch.profiler."""
    model = get_model(cfg, "cuda")
    with torch.no_grad():
        params = model.init_params(torch.Generator("cuda").manual_seed(1))
    params.requires_grad_(False)
    eng = ServeEngine(model, params, batch_slots=SLOTS, max_len=64,
                      num_clients=1)
    for i in range(SLOTS):
        eng.submit(Request(prompt=[1 + i, 2, 3], max_new_tokens=64))
    for _ in range(3):                              # admit and warm up
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    launches0 = moe_gemm.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    assert moe_gemm.launches - launches0 == per_step * n_steps
    rows = []
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            us = getattr(a, "self_device_time_total", None)
            if us is None:
                us = a.self_cuda_time_total
            rows.append((us / 1e3 / n_steps, a.count / n_steps, a.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    moe = sum(r[0] for r in rows if "moe_gemm" in r[2])
    print(f"[profile] full-width decode step, {SLOTS} slots busy: wall "
          f"{wall_ms:.3f} ms/step (no profiler); device busy {busy:.3f} "
          f"ms/step in {sum(r[1] for r in rows):.0f} kernels; idle share "
          f"{1 - busy / wall_ms:.3f}; moe_gemm {moe:.3f} ms/step "
          f"({moe / busy if busy else 0:.3f} of busy)")
    if not rows:
        print("[profile] device time not measured: the profiler saw no "
              "CUDA kernels")
    for ms, count, key in rows[:10]:
        print(f"[profile]   {ms:8.4f} ms/step {count:6.1f}x  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    # ---- 1. the card -----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak_key, (mem_bps, bf16_fps, f32_fps) = peaks_for(name)
    print(f"[card] {name}, capability {torch.cuda.get_device_capability(0)},"
          f" peaks of {peak_key}: {mem_bps / 1e12} TB/s, "
          f"{bf16_fps / 1e12} bf16 TFLOP/s, {f32_fps / 1e12} f32 TFLOP/s")

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    lib = _build.build("moe_gemm")
    print(f"[build] moe_gemm: {time.time() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build]   {line.strip()}")

    # ---- 3. kernel vs plain ---------------------------------------------
    cfg = get_config(ARCH)
    e_pad = padded_experts(cfg)
    c = SLOTS * capacity(cfg, 1)                  # decode: S=1 per slot
    d, f = cfg.d_model, cfg.moe_d_ff
    up_shape, down_shape = (e_pad, c, d, f), (e_pad, c, f, d)
    gen = torch.Generator("cuda").manual_seed(0)

    def operands(shape, dtype, scale=0.3):
        e_, c_, d_, f_ = shape
        x = torch.randn((e_, c_, d_), generator=gen, device="cuda") * scale
        w = torch.randn((e_, d_, f_), generator=gen, device="cuda") * scale
        return x.to(dtype), w.to(dtype)

    tols = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, shape in (("gate/up", up_shape), ("down", down_shape),
                             ("ragged", (3, 100, 96, 72))):
            x, w = operands(shape, dtype)
            got, want = moe_gemm(x, w), moe_gemm_ref(x, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=tols[dtype], atol=tols[dtype])
            errs[(label, dtype)] = err
            print(f"[check] moe_gemm {label} {tuple(shape)} {dtype}: "
                  f"max |kernel - plain| = {err:.3e} (holds "
                  f"|diff| <= {tols[dtype]} * (1 + |plain|))")
    x, w = operands((4, 32, 64, 64), torch.float32, 1.0)
    base = moe_gemm(x, w)
    x[2] = 999.0
    pert = moe_gemm(x, w)
    assert torch.equal(base[0], pert[0]) and torch.equal(base[3], pert[3])
    assert not torch.allclose(base[2], pert[2])
    print("[check] moe_gemm expert isolation: ok")

    # times at the path's shapes, bf16: each shape, then one MoE layer's
    # three calls (gate, up, down) as the kernel's line in the JSON
    xu, wg = operands(up_shape, torch.bfloat16)
    _, wu = operands(up_shape, torch.bfloat16)
    xd, wd = operands(down_shape, torch.bfloat16)
    calls = {"gate/up": [(xu, wg)], "down": [(xd, wd)],
             "layer": [(xu, wg), (xu, wu), (xd, wd)]}
    times = {}
    for label, args in calls.items():
        shapes = [(*x_.shape, w_.shape[2]) for x_, w_ in args]
        t = {"ms": time_ms(lambda: [moe_gemm(*a) for a in args]),
             "plain_ms": time_ms(lambda: [moe_gemm_ref(*a) for a in args]),
             "library_ms": time_ms(lambda: [torch.bmm(*a) for a in args])}
        t["bound_ms"], t["bound_by"] = bound(shapes, 2, bf16_fps, mem_bps)
        times[label] = t
        print(f"[time] moe_gemm {label} {shapes} bf16: kernel {t['ms']:.4f} "
              f"ms, plain {t['plain_ms']:.4f} ms, torch.bmm "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); kernel at "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound")
    del xu, wg, wu, xd, wd, x, w, base, pert, got, want
    torch.cuda.empty_cache()

    # ---- 4. main path: full-width serve ---------------------------------
    moe_layers = sum(b.ffn == "moe" for b in cfg.pattern) * cfg.repeats
    per_step = 3 * moe_layers
    torch.cuda.reset_peak_memory_stats()
    moe_gemm.launches = 0
    out = serve(ARCH, num_requests=REQUESTS, clients=CLIENTS, slots=SLOTS,
                max_new=MAX_NEW, tiny=False, device="cuda")
    launches = moe_gemm.launches
    peak = torch.cuda.max_memory_allocated()
    steps = out["engine_steps"]
    print(f"[serve] {ARCH} full width, {cfg.num_layers} layers, bf16: "
          f"{out['requests']} requests, {out['tokens']} tokens, {steps} "
          f"engine steps, wall {out['wall_s']:.3f} s, "
          f"{out['tok_per_s']:.2f} tok/s, "
          f"{1e3 * out['wall_s'] / steps:.2f} ms/step, peak memory "
          f"{peak / 2**30:.2f} GiB; moe_gemm launches {launches} "
          f"({per_step} per step); stats {out['stats']}")
    assert out["requests"] == REQUESTS, out
    assert out["tokens"] == REQUESTS * MAX_NEW, out
    assert per_step == 72 and launches == per_step * steps > 0, \
        (launches, per_step, steps)
    assert out["stats"]["nonfinite_steps"] == 0, out["stats"]

    # ---- 5. where a decode step's time goes -----------------------------
    del out
    profile_steps(cfg, per_step)

    # ---- 6. tiny engine == greedy reference, f32 on the card -----------
    tcfg = tiny_config(ARCH).scaled(dtype="float32")
    model = get_model(tcfg, "cuda")
    params = model.init_params(torch.Generator("cuda").manual_seed(0))
    prompts = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11, 4, 8, 1, 6]]
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, num_clients=1)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=5)) for p in prompts]
    eng.run_until_drained()
    for p, r in zip(prompts, reqs):
        want = greedy_decode(model, params,
                             torch.tensor([p], device="cuda"), 5, 32)
        assert r.output == want[0].tolist(), (p, r.output, want)
    print(f"[check] tiny {ARCH} engine == greedy decode for "
          f"{len(prompts)} requests (f32, cuda)")

    # ---- 7. results ------------------------------------------------------
    layer = times["layer"]
    kernels = [{
        "name": "moe_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm.py:21",
        "launches": launches,
        "max_abs_err": max(errs[(lb, torch.bfloat16)]
                           for lb in ("gate/up", "down")),
        "ms": layer["ms"], "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
        "library_ms": layer["library_ms"],
        "unit": "one MoE layer's three calls (gate, up, down) at the "
                "serving path's bf16 shapes",
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
