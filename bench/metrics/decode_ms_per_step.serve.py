"""`ServeEngine.decode_seconds` over `decode_steps`, summed over the calls
completed in the window, in ms (host spans that end in a device sync)."""


def read(r):
    if r["kind"] != "serve" or not r["decode_steps"]:
        return None
    return 1e3 * r["decode_seconds"] / r["decode_steps"]
