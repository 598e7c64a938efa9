"""Output bytes returned to the host, checksum verified, by every call
completed in the window over the window's seconds (GB/s)."""

from gpubench.readers import DECODE_OPS, gbps


def read(run):
    return gbps(run.bytes_out, run) if run.mix["op"] in DECODE_OPS else None
