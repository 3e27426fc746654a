"""End-to-end trainer; counterpart of `repro/launch/train.py`. The host
side runs the paper's runtime: a `TaskRuntime` in ddast mode whose two
idle workers execute the registered callbacks (DDAST message handling,
data prefetch and async checkpoint flushing), so the main thread only
issues device steps.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 50 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2-moe-a2.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch jamba-v0.1-52b --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --steps 30 --batch 4 --seq 32 --device cuda

Every arch trains on the CPU: attention + MLP archs (qwen2-0.5b,
gemma2-27b, ...), attention + MoE archs (qwen2-moe-a2.7b,
qwen3-moe-235b-a22b), the hybrid Mamba + attention + MoE arch
(jamba-v0.1-52b), xlstm-125m (autograd of the plain mLSTM and sLSTM
scans) and the encoder-decoder whisper-base, which gets zero frames [B,
encoder_seq, d_model] as the JAX trainer gives it. On the card
(`--device cuda`, the default) every arch trains through the forward and
backward kernels of flash attention, `moe_gemm`, the selective scan and
xLSTM's mLSTM and sLSTM scans. `--full` trains the published widths.
Random weights come from a seeded `torch.Generator`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --steps 30 --batch 4 --seq 32 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
      --steps 30 --batch 4 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import torch

from ..configs import ARCHS, get_config, tiny_config
from ..core.runtime import TaskRuntime
from ..device import DeviceLike, resolve_device
from ..models.registry import get_model
from ..train.checkpoint import CheckpointManager
from ..train.data import DataConfig, Prefetcher, SyntheticLM
from ..train.fault import HeartbeatMonitor
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_step import TrainConfig, make_train_step

CKPT_EVERY = 20


def train(arch: str, tiny: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str, microbatches: int = 1, resume: bool = True,
          log_every: int = 10, schedule_steps: int = 0,
          device: DeviceLike = "cuda", dtype: Optional[str] = None) -> dict:
    """Train `steps` steps (from the newest checkpoint in `ckpt_dir` when
    `resume`), saving every 20 steps and at the end. `dtype` overrides
    the config's parameter dtype. Returns per-step losses, grad norms and
    host wall seconds (each step ends in a device sync, as reading its
    loss needs one), the run's wall, the last checkpoint write, and the
    leaves the optimizer's fused pass and its plain loop updated."""
    dev = resolve_device(device)
    cfg = tiny_config(arch) if tiny else get_config(arch)
    if dtype is not None:
        cfg = cfg.scaled(dtype=dtype)
    model = get_model(cfg, dev)
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=20,
                                     total_steps=schedule_steps or steps),
                       num_microbatches=microbatches)
    step_fn = make_train_step(model, tcfg)

    params = model.init_params(torch.Generator(dev).manual_seed(0))
    opt = init_opt_state(params)

    # host runtime: idle threads do prefetch + checkpoint I/O (DDAST org)
    rt = TaskRuntime(num_workers=2, mode="ddast")
    ds = SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq))
    prefetch = Prefetcher(ds, rt.dispatcher, depth=4)
    ckpt = CheckpointManager(ckpt_dir, rt.dispatcher)
    hb = HeartbeatMonitor(hosts=["host0"])

    start_step = 0
    if resume:
        restored = ckpt.restore({"params": params.state_dict(), "opt": opt})
        if restored is not None:
            start_step, tree = restored
            params.load_state_dict(tree["params"])
            opt = tree["opt"]
            print(f"[train] resumed from step {start_step}")

    # the stub audio frontend's output: zeros, as the JAX trainer feeds it
    frames = (torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                          dtype=cfg.torch_dtype, device=dev)
              if cfg.is_encoder_decoder else None)
    losses, gnorms, step_s = [], [], []
    rt.start()
    try:
        t0 = time.perf_counter()
        for step in range(start_step, steps):
            batch_dev = {k: torch.from_numpy(v).to(dev)
                         for k, v in prefetch.get(step).items()}
            if frames is not None:
                batch_dev["frames"] = frames
            st = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch_dev)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - st)
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            hb.beat("host0", step, step_s[-1])
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {gnorms[-1]:.2f}")
            # named by the step a resume starts from (the JAX trainer
            # names it one step early: launch/train.py:75-76)
            done = step + 1
            if done % CKPT_EVERY == 0 and done < steps:
                ckpt.save(done, {"params": params.state_dict(),
                                 "opt": opt})
        ckpt.save(steps, {"params": params.state_dict(), "opt": opt},
                  blocking=True)
        wall = time.perf_counter() - t0
    finally:
        ckpt.flush()
        rt._stop.set()
        # a worker may still be writing a checkpoint it took from the
        # queue (the final one included): wait for it, within a bound
        for th in rt._threads:
            th.join(timeout=60)
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "wall_s": wall, "prefetch_async": prefetch.fills_async,
            "ckpt_writes": ckpt.async_writes, "last_ckpt": ckpt.last_write,
            "final_loss": losses[-1] if losses else None,
            "device": str(dev),
            "fused_leaves": step_fn.optimizer.fused_leaves.total,
            "plain_leaves": step_fn.optimizer.plain_leaves.total}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-0.5b")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false",
                    help="published widths instead of the tiny config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(args.arch, args.tiny, args.steps, args.batch, args.seq,
                args.ckpt_dir, args.microbatches, device=args.device)
    print(f"[train] done on {out['device']}: final loss "
          f"{out['final_loss']:.4f} ({out['wall_s']:.1f}s, "
          f"{out['prefetch_async']} async prefetches, "
          f"{out['ckpt_writes']} ckpt writes)")


if __name__ == "__main__":
    main()
