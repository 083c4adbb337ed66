"""Useful model flops of the calls completed in the window over their time and the
bf16 peak, in %: each
admitted prompt's real tokens and each decoded token, forward only, attention over
real tokens alone (`yardstick.prompt_flops`, `decode_flops`)."""

from benchkit.yardstick import PEAK_BF16


def read(r):
    if r["kind"] != "serve" or not r["calls"]:
        return None
    return 100.0 * r["useful_flops"] / r["calls_s"] / PEAK_BF16
