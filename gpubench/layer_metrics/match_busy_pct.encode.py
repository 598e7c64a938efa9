"""Share of the traced device busy time (%) spent in the match stage's
kernels: every launch of prep_kernel, matcher_kernel, small_runs_kernel
and extend_kernel in the window, their summed device time over the union
of the device's intervals (tracing.busy_ns).  PyTorch's sort of the keys
is left out: its kernels' names are shared with other stages."""

import re

from gpubench import tracing
from gpubench.readers import ENCODE_OPS

MATCH_KERNELS = re.compile(
    r"\b(prep_kernel|matcher_kernel|small_runs_kernel|extend_kernel)\b")


def read(run):
    if run.trace is None or run.mix["op"] not in ENCODE_OPS:
        return None
    busy = tracing.busy_ns(run.trace)
    if not busy:
        return None
    lo, hi = run.trace.window
    ns = sum(min(end, hi) - max(start, lo)
             for start, end, op in run.trace.device
             if MATCH_KERNELS.search(op) and end > lo and start < hi)
    return 100.0 * ns / busy
