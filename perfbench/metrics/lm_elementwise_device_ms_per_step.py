"""Device time a traced step outside matrix-product and attention kernels
(the update's and the optimizer's elementwise chains, casts, norms,
softmax), classified by kernel name."""


def read(trace, counts):
    steps = counts.get("steps_traced")
    if not trace.device or not steps:
        return None
    names = counts["matmul_names"]
    secs = trace.device_s(lambda n: not any(k in n.lower() for k in names))
    return secs * 1e3 / steps
