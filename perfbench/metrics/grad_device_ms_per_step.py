"""Device time a traced step of the work launched inside the program's
``step.grad`` span: every node's (or the replica's) forward and backward
(`launch/steps.py::_loss_and_grads`, `models/`). Each device event is put
down to the spans open at its launch (`perfbench.spans`); nothing to read
where the trace holds no such span or no device event."""
from perfbench.spans import device_s_in


def read(trace, counts):
    steps = counts.get("steps_traced")
    secs = device_s_in(trace, "step.grad")
    if secs is None or not steps:
        return None
    return secs * 1e3 / steps
