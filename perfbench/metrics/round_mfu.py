"""The whole round's share of the chip: the least bytes one round needs
(`perfbench.work.round_min_bytes`: x read once, theta read and written
once, each node's broadcast once) at the HBM peak, over the round's wall
time in the window's untraced runs (each run() call's whole wall)."""
from perfbench import peaks
from perfbench.work import round_min_bytes


def read(trace, counts):
    rounds, wall = counts.get("rounds_untraced"), counts.get("wall_untraced_s")
    if not rounds or not wall:
        return None
    ideal = round_min_bytes(counts["nodes"], counts["n"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * ideal / (wall / rounds)
