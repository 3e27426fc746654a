"""Hill-climb runner over named variants of three dry-run cells;
counterpart of `repro/launch/perf.py`.

  PYTHONPATH=src python -m repro_torch.launch.perf --iter small_baseline \
      --out dryrun_out/perf

Each iteration runs one cell (`launch.dryrun.lower_cell`) on the fake
256-rank world with its knobs and writes its record, with the roofline
terms, to `<out>/<tag>.json`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .dryrun import lower_cell

# iteration registry: tag -> (arch, shape, lower_cell kwargs)
ITERATIONS = {
    # --- cell 1: qwen3-moe train_4k (paper-representative) -------------
    "moe_baseline": ("qwen3-moe-235b-a22b", "train_4k", {}),
    "moe_local_dispatch": ("qwen3-moe-235b-a22b", "train_4k", {}),
    "moe_weight_gather": ("qwen3-moe-235b-a22b", "train_4k",
                          {"moe": "gather"}),
    "moe_grad_compress": ("qwen3-moe-235b-a22b", "train_4k",
                          {"grad_compress": True, "microbatches": 4}),
    "moe_microbatch4": ("qwen3-moe-235b-a22b", "train_4k",
                        {"microbatches": 4}),
    # --- cell 2: qwen2-72b decode_32k (most collective-bound) ----------
    "decode_baseline": ("qwen2-72b", "decode_32k", {}),
    "decode_no_fsdp": ("qwen2-72b", "decode_32k", {"fsdp": False}),
    # --- cell 3: qwen2-0.5b train_4k (worst compute fraction) ----------
    "small_baseline": ("qwen2-0.5b", "train_4k", {}),
    "small_pure_dp": ("qwen2-0.5b", "train_4k", {"tp": False}),
    "small_pure_dp_nofsdp": ("qwen2-0.5b", "train_4k",
                             {"tp": False, "fsdp": False}),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iter", required=True,
                    help="comma-separated iteration tags, or 'all'")
    ap.add_argument("--out", default="dryrun_out/perf")
    args = ap.parse_args()
    tags = list(ITERATIONS) if args.iter == "all" else args.iter.split(",")
    os.makedirs(args.out, exist_ok=True)
    for tag in tags:
        arch, shape, kw = ITERATIONS[tag]
        t0 = time.time()
        try:
            rec = lower_cell(arch, shape, multi_pod=False, **kw)
            rec["iteration"] = tag
            rec["kwargs"] = {k: str(v) for k, v in kw.items()}
        except Exception as e:  # noqa: BLE001
            rec = {"iteration": tag, "error": f"{type(e).__name__}: {e}"}
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        t = rec.get("terms_s", {})
        print(f"[{tag}] {rec.get('error') or ''} "
              f"comp={t.get('compute', 0):.3g}s mem={t.get('memory', 0):.3g}s "
              f"coll={t.get('collective', 0):.3g}s "
              f"({time.time()-t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
