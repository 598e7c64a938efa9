"""Share of their bytes bound that the encode's six kernels reach (%):
the summed bytes bound of every launch of prep_kernel, matcher_kernel,
small_runs_kernel, extend_kernel, parse_rows_kernel / parse_ring_kernel
and pack_kernel in the traced window (gpubench.bounds, at the
configuration's batch, shard and context) over 3.35 TB/s, divided by
their summed device time in the trace."""

import re

from gpubench import bounds
from gpubench.readers import ENCODE_OPS


def read(run):
    if run.trace is None or run.mix["op"] not in ENCODE_OPS:
        return None
    cfg = run.cfg
    per_launch = bounds.launch_bytes(cfg["encode_batch"], cfg["shard_len"],
                                     cfg["ctx"], cfg["level"])
    name = re.compile(r"\b(" + "|".join(per_launch) + r")\b")
    moved = ns = 0
    for start, end, op in run.trace.device:
        m = name.search(op)
        if m:
            moved += per_launch[m.group(1)]
            ns += end - start
    if not ns:
        return None
    return 100.0 * moved / bounds.HBM_BYTES_PER_S / (ns / 1e9)
