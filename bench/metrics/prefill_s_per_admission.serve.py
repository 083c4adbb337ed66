"""`ServeEngine.prefill_seconds` over `admissions`, summed over the calls completed in the window
(host spans that end in a device sync)."""


def read(r):
    if r["kind"] != "serve" or not r["admissions"]:
        return None
    return r["prefill_seconds"] / r["admissions"]
