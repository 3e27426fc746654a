"""The share of the profiled training steps' wall in which no operation
ran on the card, per cent."""
from port_bench import readers


def read(rec):
    return readers.device_idle(rec)
