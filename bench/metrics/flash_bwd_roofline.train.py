"""The flash backward's share of its roofline in the traced steps, in %: its calls
(`kernels.build.LAUNCHES`) at the traffic's shape over the device time of its
kernels (`dkdv(_tc)_kernel`, `dq(_tc)_kernel`, `delta_kernel`)."""

from benchkit import yardstick as Y
from benchkit.trace import kernel_seconds

KERNELS = r"(^|::)(dkdv(_tc)?_kernel|dq(_tc)?_kernel|delta_kernel)$"


def read(r):
    t = r["trace"]
    if r["kind"] != "train" or t is None:
        return None
    n, sec = kernel_seconds(t, KERNELS)
    calls = t["launches"].get("flash_attention_bwd", 0)
    if not n or not sec or not calls:
        return None
    s, tr = r["family"].sizes(r["cfg"]), r["traffic"]
    work = Y.flash_bwd_work(tr["batch"], s["Hq"], s["Hkv"], tr["seq"], s["dh"], s["W"])
    return 100.0 * calls * Y.bound_s(*work) / sec
