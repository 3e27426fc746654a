"""The training step's model flops (6 x active parameters x tokens, the
benchmark's copy of `model_flops`) over the window's wall, as a share
of the H100 SXM's dense bf16 peak (989 TFLOP/s); the card's power limit
is printed beside it (`device.power_limit_w`)."""
from port_bench import readers


def read(rec):
    return readers.mfu(rec, train=True)
