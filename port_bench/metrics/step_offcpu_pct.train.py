"""The share of the step calls' wall in which the stepping thread was off
the CPU (waiting for the GIL, blocked or preempted), 100 x (1 - CPU s /
wall s) of the program's step clock (`step.clock`, a `ThreadClock`) over
the window's steps, per cent."""
from port_bench import progtrace


def read(rec):
    return progtrace.offcpu_pct(rec)
