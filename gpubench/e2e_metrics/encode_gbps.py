"""Input bytes of every call completed in the window over the window's
seconds (GB/s)."""

from gpubench.readers import ENCODE_OPS, gbps


def read(run):
    return gbps(run.bytes_in, run) if run.mix["op"] in ENCODE_OPS else None
