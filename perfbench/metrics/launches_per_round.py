"""Device events (kernels, copies, sets) of one traced run over its
rounds: what the host issues for each round."""


def read(trace, counts):
    rounds = counts.get("rounds_traced")
    if not trace.device or not rounds:
        return None
    return trace.count() / rounds
