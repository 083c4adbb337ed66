"""The flash forward's share of its roofline in the traced steps, in %: its calls
(`kernels.build.LAUNCHES`, forward and remat's recompute) at the traffic's shape,
writing the LSE, over the device time of `flash_attention(_tc)_kernel`."""

from benchkit import yardstick as Y
from benchkit.trace import kernel_seconds

KERNEL = r"(^|::)flash_attention(_tc)?_kernel$"


def read(r):
    t = r["trace"]
    if r["kind"] != "train" or t is None:
        return None
    n, sec = kernel_seconds(t, KERNEL)
    calls = t["launches"].get("flash_attention", 0)
    if not n or not sec or not calls:
        return None
    s, tr = r["family"].sizes(r["cfg"]), r["traffic"]
    work = Y.flash_fwd_work(tr["batch"], s["Hq"], s["Hkv"], tr["seq"], s["dh"], s["W"], True)
    return 100.0 * calls * Y.bound_s(*work) / sec
