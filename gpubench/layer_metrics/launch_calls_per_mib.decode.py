"""Kernel and graph launch calls of the host in the traced decode window
per MiB of output (a graph replay counts 1)."""

from gpubench.readers import DECODE_OPS, launches_per_mib


def read(run):
    return launches_per_mib(run, DECODE_OPS, run.bytes_out)
