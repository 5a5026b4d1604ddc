"""The whole training step's share of the chip's bf16 peak: the model
flops of a step (`perfbench.work.lm_step_flops`, from the configuration's
widths and the tokens a step) over the step's wall time in the window's
untraced steps."""
from perfbench import peaks


def read(trace, counts):
    steps, wall = counts.get("steps_untraced"), counts.get("wall_untraced_s")
    if not steps or not wall:
        return None
    ideal = counts["flops_per_step"] / peaks.BF16_FLOPS
    return 100.0 * ideal / (wall / steps)
