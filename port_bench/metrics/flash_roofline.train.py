"""Attention's bound (forward and backward over the live causal pairs)
over the profiled time of the `flash_*` kernels, per cent."""
from port_bench import readers


def read(rec):
    return readers.flash(rec, backward=True)
