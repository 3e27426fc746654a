"""The prefill's model flops (2 x active parameters x tokens) over the
window's wall, as a share of the H100 SXM's dense bf16 peak."""
from port_bench import readers


def read(rec):
    return readers.mfu(rec, train=False)
