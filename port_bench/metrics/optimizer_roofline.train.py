"""The clip's and AdamW's bytes bound over the profiled time of the fused
optimizer kernels (names holding `adamw_`), per cent. A step must read
each parameter and write it back in the model dtype, read its gradient
once in that dtype, and read and write f32 m and v: (3 x the dtype's size
+ 16) bytes a parameter, at the card's memory rate. `param_count()`
leaves out the experts' padding and the padded vocabulary, and the f32
routers are counted at the model dtype's size, so the share can only read
low. None where no such kernel ran (the per-leaf PyTorch loop)."""
import torch

from port_bench import readers


def read(rec):
    t, n = readers.device_seconds(rec, "adamw_")
    if not n:
        return None
    a, units = rec["arch"], rec["profiled_units"]
    size = torch.empty((), dtype=getattr(torch, a.dtype)).element_size()
    one = (a.param_count() * (3 * size + 16) / rec["peaks"].hbm_bps, "bytes")
    # one norm and one update launch a step (up to
    # kernels.adamw.MAX_LEAVES leaves)
    return readers.roofline("adamw", [one] * units, t, n, 2 * units)
