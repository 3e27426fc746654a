"""Host ms a training step inside the program's `port.train.clip` and
`port.train.adamw` spans (the profiled steps): the clip's and AdamW's
per-parameter Python loop and launches."""
from port_bench import progtrace


def read(rec):
    return progtrace.host_ms(rec, progtrace.OPTIMIZER)
