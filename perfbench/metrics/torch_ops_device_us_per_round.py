"""Device time a round of everything but the port's hand-written kernels
(the torch ops around them: noise, coefficients, the faulty mix, copies),
in one traced run."""
from perfbench.trace import short_name
from perfbench.work import KERNEL_OF

HAND_WRITTEN = tuple(KERNEL_OF) + ("hinge_", "pdomd_kernel")


def hand_written(name):
    return short_name(name).split("::")[-1].startswith(HAND_WRITTEN)


def read(trace, counts):
    rounds = counts.get("rounds_traced")
    if not trace.device or not rounds:
        return None
    secs = trace.device_s(lambda name: not hand_written(name))
    return secs * 1e6 / rounds
