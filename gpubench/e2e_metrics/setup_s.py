"""Seconds from the process's start to the first timed call: imports, the
kernels' build where the checkout has none, the inputs, the streams a
decode reads, and one warm call on each input."""


def read(run):
    return run.setup_s
