"""MFU_NOTE's flops of the steps completed in the window over their host time
and the bf16 peak, in % (`yardstick.train_step_flops`)."""

from benchkit.yardstick import PEAK_BF16


def read(r):
    if r["kind"] != "train" or not r["steps"]:
        return None
    return 100.0 * r["step_flops"] * r["steps"] / r["steps_wall_s"] / PEAK_BF16
