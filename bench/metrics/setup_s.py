"""Process start to window start: loading, drawing the weights, building the
kernels where the checkout has none yet, and warming up."""


def read(r):
    return r["setup_s"]
