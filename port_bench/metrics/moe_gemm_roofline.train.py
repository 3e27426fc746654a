"""The grouped GEMM's bound (forward, dx and dw of every expert layer's
three products, on the rows the reference routes) over the profiled time
of the `moe_gemm*` kernels, per cent."""
from port_bench import readers


def read(rec):
    return readers.moe_gemm(rec, backward=True)
