"""The device's idle share of a training step
(`perfbench.trace.Trace.idle_share`: its busy time a step in the traced
steps against a step's wall in the window's untraced steps)."""


def read(trace, counts):
    return trace.idle_share(counts.get("steps_traced"),
                            counts.get("steps_untraced"),
                            counts.get("wall_untraced_s"))
