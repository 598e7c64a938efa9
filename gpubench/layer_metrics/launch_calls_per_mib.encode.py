"""Kernel and graph launch calls of the host in the traced encode window
per MiB of input (a graph replay counts 1)."""

from gpubench.readers import ENCODE_OPS, launches_per_mib


def read(run):
    return launches_per_mib(run, ENCODE_OPS, run.bytes_in)
