"""Device ms a training step of the operations launched while the
program's `port.train.clip` or `port.train.adamw` span was open (launches
matched to kernels by correlation; the profiled steps): the clip's and
AdamW's own device time, which `elementwise_ms.train` mixes with the
forward's and backward's elementwise work."""
from port_bench import progtrace


def read(rec):
    return progtrace.launched_ms(rec, progtrace.OPTIMIZER)
