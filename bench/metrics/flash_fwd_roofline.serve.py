"""The flash forward's share of its roofline in the traced call, in %: the least
time of every prefill's calls (one a layer, at the admission's rows and padded
length, causal) over the device time of `flash_attention(_tc)_kernel`. Nothing
where the program's launches (`kernels.build.LAUNCHES`) show that some prefill
took another path than the kernel."""

from benchkit import yardstick as Y
from benchkit.trace import kernel_seconds

KERNEL = r"(^|::)flash_attention(_tc)?_kernel$"


def read(r):
    t = r["trace"]
    if r["kind"] != "serve" or t is None:
        return None
    n, sec = kernel_seconds(t, KERNEL)
    s = r["family"].sizes(r["cfg"])
    if not n or not sec or t["launches"].get("flash_attention", 0) != s["L"] * len(t["prefills"]):
        return None
    least = sum(Y.bound_s(*Y.flash_fwd_work(rows, s["Hq"], s["Hkv"], S, s["dh"], s["W"], False))
                for rows, S in t["prefills"]) * s["L"]
    return 100.0 * least / sec
