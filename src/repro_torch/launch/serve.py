"""Serving launcher: builds the continuous-batching engine on an arch
(tiny by default, `--full` for the published widths) with random weights
from a seeded `torch.Generator`, and runs a synthetic request workload
from several client threads. Counterpart of `repro/launch/serve.py`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --full --requests 16 --clients 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --device cpu

Every decoder-only arch serves on both devices; the encoder-decoder
whisper-base is refused, as by the JAX launcher.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Any

import numpy as np
import torch

from ..configs import ARCHS, get_config, tiny_config
from ..device import DeviceLike, resolve_device
from ..models.registry import ModelAPI, get_model
from ..serve.engine import Request, ServeEngine


def serve(arch: str, num_requests: int, clients: int, slots: int = 4,
          max_new: int = 8, tiny: bool = True,
          device: DeviceLike = "cuda") -> dict:
    dev = resolve_device(device)
    cfg = tiny_config(arch) if tiny else get_config(arch)
    if cfg.is_encoder_decoder:
        raise SystemExit("serve launcher targets decoder-only archs")
    model = get_model(cfg, dev)
    with torch.no_grad():
        params = model.init_params(torch.Generator(dev).manual_seed(0))
    params.requires_grad_(False)
    return serve_requests(model, params, num_requests, clients, slots,
                          max_new)


def serve_requests(model: ModelAPI, params: Any, num_requests: int,
                   clients: int, slots: int = 4, max_new: int = 8) -> dict:
    """Run the synthetic workload on a model whose params exist already:
    `num_requests` prompts of 2-9 tokens drawn from a fixed seed, sent
    round-robin from `clients` threads into an engine of `slots` batch
    slots, each asking for `max_new` tokens."""
    dev = model.device
    eng = ServeEngine(model, params, batch_slots=slots, max_len=64,
                      num_clients=clients)
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(1, 100, rng.randint(2, 10)).tolist(),
                    max_new_tokens=max_new) for _ in range(num_requests)]

    def client(cid: int) -> None:
        for i, r in enumerate(reqs):
            if i % clients == cid:
                eng.submit(r, client_id=cid)
                time.sleep(0.001)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    # engine thread = the DDAST manager draining client queues
    while len(eng.completed) < num_requests:
        eng.step()
        if time.time() - t0 > 120:
            raise RuntimeError("serve timeout")
    for t in threads:
        t.join()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    toks = sum(len(r.output) for r in eng.completed)
    return {"wall_s": wall, "requests": len(eng.completed),
            "tokens": toks, "engine_steps": eng.steps,
            "tok_per_s": toks / wall, "stats": eng.stats,
            "device": str(dev)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="published widths instead of the tiny config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = serve(args.arch, args.requests, args.clients, args.slots,
                tiny=not args.full, device=args.device)
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens in "
          f"{out['wall_s']:.1f}s ({out['tok_per_s']:.1f} tok/s, "
          f"{out['engine_steps']} engine steps on {out['device']})")
    print(f"[serve] scheduler stats: {out['stats']}")


if __name__ == "__main__":
    main()
