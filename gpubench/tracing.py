"""What a torch.profiler trace of the window says: when the device was
busy, which device operations took the time, what the host was doing
while the device was idle, and how many launches the host made.

Device work is every event on the device's timeline (kernels, memory
copies and sets); the busy time is the union of their intervals, not
their sum.  A launch is a
CUDA runtime or driver call that launches a kernel or a graph (a graph
replay counts once).  Times are in nanoseconds of the trace's clock."""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel"
                    r"|cuLaunchKernelEx|cudaGraphLaunch|cuGraphLaunch)"
                    r"(_v\d+|_ptsz)?$")
SPAN_PREFIX = "gpubench."
# how far back from a gap the host events are searched for one that covers
# it: host events are short, so the one open at a gap started just before
LOOKBACK = 512


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name)
    spans: list = field(default_factory=list)    # (start, end, name)
    launches: int = 0
    kinds: dict = field(default_factory=dict)    # device type -> events
    launch_names: dict = field(default_factory=dict)  # launch call -> count

    @property
    def window(self) -> tuple[int, int]:
        """From the start of the first call's span to the end of the
        last's."""
        return (min(s for s, _, _ in self.spans),
                max(e for _, e, _ in self.spans))


def read(prof) -> Trace:
    """The trace of a stopped torch.profiler.profile."""
    t = Trace()
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        t.kinds[kind] = t.kinds.get(kind, 0) + 1
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if "CUDA" in kind:
            # the profiler's copy of a span on the device timeline is no
            # device work
            if not name.startswith(SPAN_PREFIX):
                device.append((start, end, name))
        elif "CPU" in kind:
            if name.startswith(SPAN_PREFIX):
                t.spans.append((start, end, name))
            else:
                host.append((start, end, name))
    lo, hi = t.window
    t.device = sorted(d for d in device if d[1] > lo and d[0] < hi)
    t.host = sorted(h for h in host if h[1] > lo and h[0] < hi)
    for _, _, name in t.host:
        if LAUNCH.match(name):
            t.launch_names[name] = t.launch_names.get(name, 0) + 1
    t.launches = sum(t.launch_names.values())
    return t


def busy_intervals(t: Trace) -> list:
    """The union of the device's intervals inside the window."""
    lo, hi = t.window
    out: list = []
    for s, e, _ in t.device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(t: Trace) -> int:
    return sum(e - s for s, e in busy_intervals(t))


def device_time_by_name(t: Trace) -> dict:
    """Summed device time of each operation name (ns)."""
    out: dict = {}
    for s, e, name in t.device:
        out[name] = out.get(name, 0) + e - s
    return out


def _label(t: Trace, starts: list, at: int) -> str:
    """What the host was doing at `at`: the innermost host operation open
    then (the latest started that has not ended), else the benchmark's span
    of the call, as Python between operations."""
    i = bisect.bisect_right(starts, at)
    for j in range(i - 1, max(i - 1 - LOOKBACK, -1), -1):
        s, e, name = t.host[j]
        if e > at:
            return name
    for s, e, name in t.spans:
        if s <= at < e:
            return f"host code between operations in {name}"
    return "between calls"


def idle_by_host(t: Trace) -> dict:
    """Idle device time (ns) inside the window, summed by what the host was
    doing at the middle of each idle gap."""
    lo, hi = t.window
    starts = [h[0] for h in t.host]
    out: dict = {}
    prev = lo
    for s, e in busy_intervals(t) + [[hi, hi]]:
        if s > prev:
            name = _label(t, starts, (prev + s) // 2)
            out[name] = out.get(name, 0) + s - prev
        prev = max(prev, e)
    return out


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of a name -> ns dict, as [name, seconds]."""
    return [[name[:200], ns / 1e9]
            for name, ns in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
