"""Output tokens of the calls completed in the window, over the time from the
window's start to the last one's end (host clock). The serving cell's rate is
paced by the host's Python dispatch, so it moves with the shared host's pace
from run to run; it stands per layer, beside the end-to-end `itl_p95_ms`."""


def read(r):
    if r["kind"] != "serve" or not r["calls"]:
        return None
    return r["tokens"] / r["calls_s"]
