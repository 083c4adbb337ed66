"""`torch.cuda.max_memory_allocated` over the window, reset at its start, in GiB."""


def read(r):
    if r["kind"] != "train" or not r["peak_window_bytes"]:
        return None
    return r["peak_window_bytes"] / 2**30
