"""Host time of a training step's call, from the call to its return before
the loss is read (the step's enqueue: the trainer's loop, the running
`TaskRuntime`, the autograd and optimizer launches), mean over the
window's steps, by the harness's clock."""
from port_bench import readers


def read(rec):
    return readers.host_mean_ms(rec, "step_call_s")
