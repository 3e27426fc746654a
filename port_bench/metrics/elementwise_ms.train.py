"""Device ms a training step in the group "elementwise and copies":
AdamW's per-parameter f32 arithmetic, the clip, the casts and the
activations' elementwise work, by kernel name. The groups are frozen
here (from `chip_smoke.py`'s KERNEL_GROUPS): a kernel falls in the first
group one of whose substrings its name holds, so a kernel of a named
group above never counts as elementwise."""

GROUPS = (("moe_gemm backward", ("moe_gemm_dx", "moe_gemm_dw",
                                 "moe_gemm_bwd")),
          ("moe_gemm", ("moe_gemm",)),
          ("selective scan backward", ("sel_scan_bwd",)),
          ("selective scan", ("sel_scan",)),
          ("xLSTM backward", ("mlstm_bwd", "slstm_scan_bwd")),
          ("xLSTM scans", ("mlstm_scan", "slstm_scan")),
          ("flash attention", ("flash_",)),
          ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
          ("softmax (loss)", ("SoftMax",)),
          ("reductions", ("reduce_kernel",)),
          ("elementwise and copies", ("elementwise", "copy")))


def group(name: str) -> str:
    return next((g for g, subs in GROUPS if any(s in name for s in subs)),
                "other")


def read(rec):
    ops = rec["profile"].ops
    if not ops:
        return None
    t = sum(s for name, s in ops if group(name) == "elementwise and copies")
    return 1e3 * t / rec["profiled_units"]
