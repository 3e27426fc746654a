#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the repository root on a machine with a Hopper card and `nvcc`.
Phases, in order; any failure raises and exits non-zero (no phase catches
its own failure):

  1. the card's name and power limit (nvidia-smi); TF32 off for f32;
  2. build the `moe_gemm` and `flash_attention` kernels from
     `src/repro_torch/kernels/csrc/` with nvcc for sm_90a, one nvcc per
     source, started together; print the build times and ptxas's report;
  3. `moe_gemm` against its plain PyTorch version on the card: the serving
     path's two shapes in bf16 and f32, a ragged shape, expert isolation;
     times (CUDA events, median after warm-up) of the kernel, the plain
     version and `torch.bmm`, beside the least time the card could take;
  4. the flash-attention forward and backward kernels against their plain
     versions (and the backward against autograd through `attention_ref`)
     at the training path's shape, a ragged S, MQA at head dim 128 and
     causal + window + softcap, in bf16 and f32; times of the kernels,
     the plain versions and `scaled_dot_product_attention` at the path's
     shape, beside their bounds;
  5. slice 1's main path: `serve()` on full-width qwen2-moe-a2.7b with
     random bf16 weights from a seeded generator, with the `moe_gemm`
     launch count set to 0 just before and read just after;
  6. where a full-width decode step's time goes: host wall per step, then
     a torch.profiler window over the same steps for device busy time by
     kernel (device idle share = 1 - busy / wall);
  7. the tiny qwen2-moe engine in f32 on the card gives the same tokens as
     the port's greedy decode for each request;
  8. `moe_gemm` on a CUDA weight that requires grad raises (its backward
     is not ported);
  9. slice 2's main path: `train()` on full-width qwen2-0.5b, 6 steps of
     B=4 x S=2048 in bf16, with the flash-attention launch counts set to
     0 just before and read just after; then a torch.profiler window over
     two train steps;
 10. tiny qwen2-0.5b training in f32 on the card: the loss falls over 24
     steps, and a resume from the step-24 checkpoint to step 30 equals a
     straight run to step 30;
 11. a JSON line with the kernels' numbers, then, last, the result line
     {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is visible.
"""
from __future__ import annotations

import ctypes
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.core.dispatcher import FunctionalityDispatcher  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.moe_gemm import moe_gemm  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref, flash_attention_bwd_ref, flash_attention_ref, moe_gemm_ref)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import idle_workers, train  # noqa: E402
from repro_torch.models.moe import capacity, padded_experts  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import greedy_decode  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig, make_train_step)

ARCH = "qwen2-moe-a2.7b"
SLOTS, CLIENTS, REQUESTS, MAX_NEW = 4, 4, 16, 8
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 2048
BWD_KERNELS = 2                         # dq, then dk/dv, per backward call
# (B, S, nq, nkv, hd, window, softcap), all causal with S == T
ATTN_CASES = {"path": (4, 2048, 14, 2, 64, None, None),
              "ragged S=200": (2, 200, 14, 2, 64, None, None),
              "MQA 4:1 hd128": (2, 256, 4, 1, 128, None, None),
              "window+softcap": (1, 256, 4, 2, 64, 64, 50.0)}

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


def attn_bound(b, s, nq, hd, itemsize, products, nbytes, flops_peak,
               bytes_peak):
    """Least ms for causal attention over b x nq heads of S == T = s:
    `products` matrix products over the s(s+1)/2 live (query, key) pairs,
    2*hd flops each, at the peak rate, or `nbytes` at the memory rate."""
    pairs = b * nq * s * (s + 1) // 2
    t_ops = products * 2 * pairs * hd / flops_peak
    t_bytes = nbytes / bytes_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def ptxas_report(lib: Path) -> None:
    """ptxas's registers, spills and static smem for each kernel entry."""
    name = "?"
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(\w+_kernel)I(13__nv_bfloat16|f)(?:Li(\d+)E)?",
                          m.group(1))
            name = (f"{k.group(1)}<{'bf16' if k.group(2) != 'f' else 'f32'}"
                    f"{', hd ' + k.group(3) if k.group(3) else ''}>"
                    if k else m.group(1))
        elif "registers" in line or "spill" in line or "smem" in line:
            print(f"[build]   {name}: {line.strip()}")


def attn_inputs(case, dtype, gen):
    b, s, nq, nkv, hd, _, _ = case
    q = torch.randn((b, s, nq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, nkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, nkv, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, s, nq, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def check_flash(gen) -> dict:
    """Forward and backward kernels against their plain versions, and the
    backward against autograd through `attention_ref`. Returns the max
    |kernel - plain| at the path's shape in bf16 for o and for the grads."""
    # o: the kernel rounds once, to the input dtype (tests/test_kernels.py
    # tolerances). lse: f32 arithmetic on both sides from the same inputs,
    # summed in another order. Grads vs the plain backward: the same f32
    # arithmetic from the same o and lse, one rounding to the input dtype.
    # Grads vs autograd through attention_ref: in f32 only the summation
    # order differs; in bf16 attention_ref also rounds the softmax weights
    # to bf16 before P@V and its D comes from the unrounded output, so the
    # bf16 grads carry about one more bf16 rounding.
    tol_o = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    tol_lse = 1e-5
    tol_g = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    tol_ag = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, case in ATTN_CASES.items():
            kw = dict(causal=True, window=case[5], softcap=case[6])
            q, k, v, do = attn_inputs(case, dtype, gen)
            o, lse = flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            ro, rlse = flash_attention_ref(q, k, v, **kw)
            torch.testing.assert_close(o.float(), ro.float(),
                                       rtol=tol_o[dtype], atol=tol_o[dtype])
            torch.testing.assert_close(lse, rlse, rtol=tol_lse,
                                       atol=tol_lse)
            grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            rgrads = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
            qa, ka, va = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            agrads = torch.autograd.grad(
                attention_ref(qa, ka, va, **kw), (qa, ka, va), do)
            e_g = e_ag = 0.0
            for name, g, rg, ag in zip("qkv", grads, rgrads, agrads):
                torch.testing.assert_close(g.float(), rg.float(),
                                           rtol=tol_g[dtype],
                                           atol=tol_g[dtype])
                torch.testing.assert_close(g.float(), ag.float(),
                                           rtol=tol_ag[dtype],
                                           atol=tol_ag[dtype])
                e_g = max(e_g, (g.float() - rg.float()).abs().max().item())
                e_ag = max(e_ag, (g.float() - ag.float()).abs().max().item())
            e_o = (o.float() - ro.float()).abs().max().item()
            e_lse = (lse - rlse).abs().max().item()
            errs[(label, dtype)] = (e_o, e_g)
            print(f"[check] flash_attention {label} {case[:5]} window "
                  f"{case[5]} softcap {case[6]} {dtype}: max |kernel - "
                  f"plain| o {e_o:.3e} (tol {tol_o[dtype]}), lse "
                  f"{e_lse:.3e} (tol {tol_lse}); dq/dk/dv vs plain "
                  f"backward {e_g:.3e} (tol {tol_g[dtype]}), vs autograd "
                  f"through attention_ref {e_ag:.3e} (tol {tol_ag[dtype]}); "
                  f"tolerances hold |diff| <= tol * (1 + |plain|)")
            del q, k, v, do, o, lse, ro, rlse, grads, rgrads, agrads, qa, \
                ka, va
            torch.cuda.empty_cache()
    return {"o": errs[("path", torch.bfloat16)][0],
            "grads": errs[("path", torch.bfloat16)][1]}


def time_flash(gen, bf16_fps, mem_bps) -> dict:
    """Forward and backward at the path's shape in bf16: the kernels, the
    plain versions and SDPA (forward; backward alone through
    autograd.grad on a retained graph), beside their bounds."""
    case = ATTN_CASES["path"]
    b, s, nq, nkv, hd, _, _ = case
    q, k, v, do = attn_inputs(case, torch.bfloat16, gen)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dos = do.transpose(1, 2).contiguous()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True)

    def sdpa_no_grad():
        with torch.no_grad():
            return sdpa()

    so = sdpa()
    sdpa_bwd = lambda: torch.autograd.grad(so, (qs, ks, vs), dos,  # noqa: E731
                                           retain_graph=True)
    sdpa_fwd_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa(), (qs, ks, vs), dos)
    qkv = 2 * (q.numel() + k.numel() + v.numel())
    lse_b = 4 * lse.numel()
    out = {}
    fwd = {"ms": time_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
           "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v,
                                                           causal=True)),
           "library_ms": time_ms(sdpa_no_grad)}
    fwd["bound_ms"], fwd["bound_by"] = attn_bound(
        b, s, nq, hd, 2, 2, qkv + 2 * o.numel() + lse_b, bf16_fps, mem_bps)
    bwd = {"ms": time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                     causal=True)),
           "plain_ms": time_ms(lambda: flash_attention_bwd_ref(
               q, k, v, o, lse, do, causal=True)),
           "library_ms": time_ms(sdpa_bwd)}
    bwd["bound_ms"], bwd["bound_by"] = attn_bound(
        b, s, nq, hd, 2, 5, 2 * qkv + 4 * o.numel() + lse_b, bf16_fps,
        mem_bps)
    fwd_bwd_lib = time_ms(sdpa_fwd_bwd)
    for label, t in (("forward", fwd), ("backward", bwd)):
        print(f"[time] flash_attention {label} {case[:5]} causal bf16: "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"SDPA {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
              f"ms ({t['bound_by']}); kernel at "
              f"{100 * t['bound_ms'] / t['ms']:.2f}% of the bound")
        out[label] = t
    print(f"[time] flash_attention forward+backward: kernels "
          f"{fwd['ms'] + bwd['ms']:.4f} ms, SDPA {fwd_bwd_lib:.4f} ms")
    del q, k, v, do, o, lse, qs, ks, vs, dos, so
    torch.cuda.empty_cache()
    return out


# kernel-name substrings -> the group a train step's device time is
# summed under (first match wins)
KERNEL_GROUPS = (("flash attention", ("flash_",)),
                 ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("softmax (loss)", ("SoftMax",)),
                 ("reductions", ("reduce_kernel",)),
                 ("elementwise and copies", ("elementwise", "copy")))


def profile_train(cfg, n_steps: int = 2) -> None:
    """Full-width train steps: host wall per step without the profiler,
    with and without the launcher's two idle dispatcher threads running
    (no thread first and last), then device busy time per step by kernel
    and by group under torch.profiler."""
    model = get_model(cfg, "cuda")
    params = model.init_params(torch.Generator("cuda").manual_seed(1))
    opt = init_opt_state(params)
    step_fn = make_train_step(model, TrainConfig(opt=OptConfig(
        peak_lr=1e-3, warmup_steps=20, total_steps=100)))
    ds = SyntheticLM(cfg, DataConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in ds.batch_at(i).items()} for i in range(3)]
    step_fn(params, opt, batches[0])                    # warm up
    torch.cuda.synchronize()

    def wall_ms() -> float:
        t0 = time.perf_counter()
        for i in range(n_steps):
            step_fn(params, opt, batches[1 + i % 2])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    plain, threaded = [wall_ms()], []
    for _ in range(2):
        with idle_workers(FunctionalityDispatcher()):
            threaded.append(wall_ms())
    plain.append(wall_ms())
    print(f"[profile] train step host wall, ms/step over {n_steps} steps: "
          f"no idle threads {[round(x, 3) for x in plain]}, two idle "
          f"dispatcher threads {[round(x, 3) for x in threaded]}")
    wall = statistics.mean(plain)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_steps):
            step_fn(params, opt, batches[1 + i % 2])
        torch.cuda.synchronize()
    rows = kernel_rows(prof, n_steps)
    busy = sum(r[0] for r in rows)
    attn = sum(r[0] for r in rows if "flash_" in r[2])
    print(f"[profile] full-width {TRAIN_ARCH} train step, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}: wall {wall:.3f} ms/step (no profiler, no idle "
          f"threads); device busy {busy:.3f} ms/step in "
          f"{sum(r[1] for r in rows):.0f} kernels; idle share "
          f"{1 - busy / wall:.3f}; flash-attention kernels {attn:.3f} "
          f"ms/step ({attn / busy if busy else 0:.3f} of busy)")
    if not rows:
        print("[profile] device time not measured: the profiler saw no "
              "CUDA kernels")
    groups = {}
    for ms, count, key in rows:
        g = next((g for g, subs in KERNEL_GROUPS
                  if any(x in key for x in subs)), "other")
        ms0, n0 = groups.get(g, (0.0, 0.0))
        groups[g] = (ms0 + ms, n0 + count)
    print("[profile] by group, ms/step (launches/step): " + "; ".join(
        f"{g} {ms:.3f} ({n:.0f})" for g, (ms, n) in
        sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for ms, count, key in rows[:12]:
        print(f"[profile]   {ms:8.4f} ms/step {count:6.1f}x  {key[:90]}")


def kernel_rows(prof, n_steps: int):
    """(device ms per step, launches per step, name) for each kernel the
    profiler saw, longest first."""
    rows = []
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            us = getattr(a, "self_device_time_total", None)
            if us is None:
                us = a.self_cuda_time_total
            rows.append((us / 1e3 / n_steps, a.count / n_steps, a.key))
    rows.sort(reverse=True)
    return rows


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
    rows = kernel_rows(prof, n_steps)
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

    # ---- 2. build, one nvcc per source, all started together ----------
    def timed_build(name):
        t0 = time.time()
        return name, _build.build(name), time.time() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        built = list(pool.map(timed_build, ["moe_gemm", "flash_attention"]))
    for kname, lib, secs in built:
        print(f"[build] {kname}: {secs:.2f} s -> {lib.name}")
        ptxas_report(lib)
    flib = fa._lib()
    flib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    for which, kname in enumerate(("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                   "flash_bwd_dkdv_kernel")):
        print(f"[build]   {kname}: dynamic smem " + ", ".join(
            f"hd {hd} {flib.flash_attention_smem_bytes(which, hd)} B"
            for hd in fa.HEAD_DIMS))

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

    # ---- 4. flash attention vs plain, and its times ---------------------
    flash_errs = check_flash(gen)
    flash_times = time_flash(gen, bf16_fps, mem_bps)

    # ---- 5. slice 1's main path: full-width serve -----------------------
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

    # ---- 6. where a decode step's time goes -----------------------------
    del out
    profile_steps(cfg, per_step)

    # ---- 7. tiny engine == greedy reference, f32 on the card -----------
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

    del model, params, eng
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8. moe_gemm under grad raises ---------------------------------
    x = torch.randn((2, 16, 64), device="cuda")
    w = torch.randn((2, 64, 64), device="cuda", requires_grad=True)
    try:
        moe_gemm(x, w)
    except NotImplementedError as e:
        print(f"[check] moe_gemm on a weight that requires grad raises: {e}")
    else:
        raise AssertionError("moe_gemm under grad did not raise")
    with torch.no_grad():
        moe_gemm(x, w)

    # ---- 9. slice 2's main path: full-width training --------------------
    tcfg = get_config(TRAIN_ARCH)
    n_attn = sum(b.mixer.startswith("attn") for b in tcfg.pattern) \
        * tcfg.repeats
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        fa.flash_attention_bwd.launches = 0
        tout = train(TRAIN_ARCH, tiny=False, steps=TRAIN_STEPS,
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                     log_every=1, device="cuda")
        fwd_launches = fa.flash_attention.launches
        bwd_launches = fa.flash_attention_bwd.launches
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ck = tout["last_ckpt"]
    print(f"[train] {TRAIN_ARCH} full width, {tcfg.num_layers} layers, bf16, "
          f"B={TRAIN_BATCH} S={TRAIN_SEQ}: losses "
          f"{[round(x_, 4) for x_ in tout['losses']]}; grad norms "
          f"{[round(x_, 4) for x_ in tout['grad_norms']]}")
    print(f"[train] wall per step (host, ends in the loss's sync, two idle "
          f"dispatcher threads running) "
          f"{[round(1e3 * t, 1) for t in tout['step_s']]} ms; steps 2.. "
          f"median {1e3 * statistics.median(tout['step_s'][1:]):.1f} ms, "
          f"{tokens / statistics.median(tout['step_s'][1:]):.0f} tok/s; "
          f"peak memory {peak / 2**30:.2f} GiB; final checkpoint "
          f"{ck['bytes'] / 1e9:.3f} GB written in {ck['seconds']:.2f} s; "
          f"flash launches forward {fwd_launches}, backward {bwd_launches}")
    assert all(math.isfinite(x_) for x_ in tout["losses"] + tout["grad_norms"])
    assert len(tout["losses"]) == TRAIN_STEPS
    assert n_attn == 24 and fwd_launches == n_attn * TRAIN_STEPS, \
        (fwd_launches, n_attn)
    assert bwd_launches == n_attn * TRAIN_STEPS * BWD_KERNELS, bwd_launches
    del tout
    gc.collect()
    torch.cuda.empty_cache()
    profile_train(tcfg)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. tiny training in f32 on the card: learns, resumes exactly --
    tiny_dir = tempfile.mkdtemp(prefix="chip_smoke_tiny_")
    try:
        run = dict(tiny=True, batch=4, seq=32, log_every=100,
                   schedule_steps=30, device="cuda", dtype="float32")
        d1, d2 = str(Path(tiny_dir) / "a"), str(Path(tiny_dir) / "b")
        first = train(TRAIN_ARCH, steps=24, ckpt_dir=d1, **run)
        resumed = train(TRAIN_ARCH, steps=30, ckpt_dir=d1, **run)
        straight = train(TRAIN_ARCH, steps=30, ckpt_dir=d2, **run)
    finally:
        shutil.rmtree(tiny_dir, ignore_errors=True)
    assert first["final_loss"] < first["losses"][0], first["losses"]
    assert len(resumed["losses"]) == 6
    assert math.isclose(resumed["losses"][-1], straight["losses"][-1],
                        rel_tol=1e-4), (resumed["losses"], straight["losses"])
    print(f"[check] tiny {TRAIN_ARCH} f32 training on the card: loss "
          f"{first['losses'][0]:.4f} -> {first['final_loss']:.4f} over 24 "
          f"steps; step-30 loss resumed from step 24 "
          f"{resumed['losses'][-1]:.6f}, straight "
          f"{straight['losses'][-1]:.6f}")

    # ---- 11. results -----------------------------------------------------
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
    for kname, replaces, count, err, t in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:30",
             fwd_launches, flash_errs["o"], flash_times["forward"]),
            ("flash_attention_bwd", None, bwd_launches, flash_errs["grads"],
             flash_times["backward"])):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": replaces, "launches": count, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "unit": "one layer's call at the training path's bf16 shape "
                    "(B=4, S=T=2048, 14:2 heads, hd 64, causal)"
                    + ("; two launches (dq, dk/dv), library = SDPA's "
                       "backward alone" if kname.endswith("bwd") else ""),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
