"""The 95th percentile of `Trainer.fit`'s `step_time_s` over the window's steps."""

import numpy as np


def read(r):
    if r["kind"] != "train" or not r["step_time_s"]:
        return None
    return float(np.percentile(r["step_time_s"], 95))
