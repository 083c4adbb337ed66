"""Tokens of the training steps completed in the window, over the host time from
the window's start to the last of them ending."""


def read(r):
    if r["kind"] != "train" or not r["steps"]:
        return None
    return r["tokens"] / r["steps_wall_s"]
