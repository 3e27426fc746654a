"""The selective scan's bound (its exponentials and f32 flops, or its
bytes) over the profiled time of the `sel_scan*` kernels, per cent."""
from port_bench import readers


def read(rec):
    return readers.sel_scan(rec)
