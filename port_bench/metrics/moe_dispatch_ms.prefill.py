"""Device ms a prefill call of the operations launched while one of the
program's `port.moe.route`, `port.moe.dispatch` or `port.moe.combine`
spans was open (the profiled calls): the MoE layers' routing, sort,
one-hot count, gathers and combine, around the grouped GEMM."""
from port_bench import progtrace


def read(rec):
    return progtrace.launched_ms(rec, progtrace.MOE)
