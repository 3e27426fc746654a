"""Device operations a training step launched while the program's
`port.train.clip` or `port.train.adamw` span was open (the profiled
steps): a count, the same in every run of a configuration."""
from port_bench import progtrace


def read(rec):
    return progtrace.launches(rec, progtrace.OPTIMIZER)
