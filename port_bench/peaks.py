"""The yardstick's table of peaks: NVIDIA's H100 Tensor Core GPU data
sheet, dense rates without sparsity, copied from the program's
`analysis/roofline.py` (`PEAKS`, `peaks_for`) so that no later change to
the program moves it. The SFU rate (exponentials a second) is the SXM
part's 132 SMs at its 1,980 MHz boost clock, 16 results a clock an SM.
Every rate assumes the card's full power limit; a card set below it is
named beside each share (`device.power_limit_w`)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple


class Peaks(NamedTuple):
    hbm_bps: float       # HBM bytes/s
    bf16_fps: float      # dense bf16 tensor-core flop/s
    f32_fps: float       # f32 CUDA-core flop/s
    sfu_eps: float       # exp2 results/s on the special-function units


PEAKS: Dict[str, Peaks] = {
    "H100 SXM": Peaks(3.35e12, 989e12, 67e12, 132 * 16 * 1980e6),
    "H100 PCIe": Peaks(2.0e12, 756e12, 51e12, 114 * 16 * 1755e6),
    "H100 NVL": Peaks(3.9e12, 835e12, 60e12, 132 * 16 * 1785e6),
}

# flops an exp2 costs when computed on the FMA pipes instead of the SFU
EXP2_FMA_FLOPS = 10


def peaks_for(name: str) -> Tuple[str, Peaks]:
    """The data-sheet part a device name (`torch.cuda.get_device_name`)
    denotes, and its rates; the SXM part by default."""
    key = ("H100 PCIe" if "PCIe" in name else
           "H100 NVL" if "NVL" in name else "H100 SXM")
    return key, PEAKS[key]
