"""What the metric readers in `e2e_metrics/` and `layer_metrics/` share.
A reader is `read(run) -> float | None` (run: harness.Run); None when the
run has nothing for it to read."""

from __future__ import annotations

from . import tracing

ENCODE_OPS = {"compress"}
DECODE_OPS = {"decompress", "decompressor"}
MIB = 1 << 20


def gbps(nbytes: int, run) -> float | None:
    """Bytes over the window's seconds, in GB/s."""
    return nbytes / run.window_s / 1e9 if nbytes and run.window_s > 0 else None


def idle_pct(run, ops: set) -> float | None:
    """The share of the traced window in which no kernel, copy or set ran
    on the device."""
    if run.trace is None or run.mix["op"] not in ops:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - tracing.busy_ns(run.trace) / (hi - lo))


def launches_per_mib(run, ops: set, nbytes: int) -> float | None:
    """Launch calls the host made in the traced window per MiB of
    `nbytes`."""
    if run.trace is None or run.mix["op"] not in ops or not nbytes:
        return None
    return run.trace.launches / (nbytes / MIB)
