"""1 minus the union of the device's busy intervals over the traced part's wall, in %."""


def read(r):
    t = r["trace"]
    if r["kind"] != "train" or t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
