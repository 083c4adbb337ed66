"""The 95th percentile of every gap between two consecutive output tokens of one
request, over the calls completed in the window; an admission's prefill stall is
such a gap."""

import numpy as np


def read(r):
    if r["kind"] != "serve" or not r["itl_ms"]:
        return None
    return float(np.percentile(r["itl_ms"], 95))
