"""The trainer runtime's idle polls a step: each time one of its workers
found no task and offered itself to the dispatcher
(`TaskRuntime.idle_polls`), over the window, per step."""
from port_bench import progtrace


def read(rec):
    return progtrace.idle_polls_per_step(rec)
