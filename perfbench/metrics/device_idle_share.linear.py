"""The device's idle share of a round (`perfbench.trace.Trace.idle_share`:
its busy time a round in the traced run, the union of its kernels, copies
and sets, against a round's wall in the window's untraced runs)."""


def read(trace, counts):
    return trace.idle_share(counts.get("rounds_traced"),
                            counts.get("rounds_untraced"),
                            counts.get("wall_untraced_s"))
