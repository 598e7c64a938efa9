"""The program's own stage spans over a traced run: which stage was open
while the device sat idle, and which stage made each launch.

While a torch.profiler records, flate_tpu_torch.metrics records a span per
stage of an encode batch, a decode batch or round and a streaming step,
stamped on the clock of the trace's host events.  read(run) takes them
(metrics.spans()) once the window has closed, keeps those inside the
trace's window and lays them over tracing.busy_intervals: every ns of
device idle time in the window goes to the innermost program span open at
that ns (the open span that started last), exactly, by a sweep over the
spans' edges; and every launch call of the trace (tracing.LAUNCH) to the
innermost span open at its start.  Time and launches outside every
program span go to NO_SPAN.  It logs the table on stderr once a run.

A run without a trace, or a program that records no spans, has no table:
its readers give None."""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass

from . import tracing

NO_SPAN = "(no program span)"
# a span named <layer>.<stage> of one of these layers is a stage span; the
# rest are the ops' own spans (gzip.compress, device.decompress_any, ...)
STAGE_LAYERS = ("encode", "decode", "chain", "stream")


@dataclass
class Table:
    window_ns: int
    idle_ns: dict       # innermost span name -> idle device ns
    launches: dict      # innermost span name -> launch calls
    count: dict         # span name -> spans that start in the window


def program_spans() -> list:
    """The program's recorded spans; none where it records none."""
    from flate_tpu_torch import metrics
    read = getattr(metrics, "spans", None)
    return read() if read is not None else []


def segments(spans: list, lo: int, hi: int) -> list:
    """[lo, hi) cut where a span opens or closes, each piece labelled with
    the innermost span open over it (NO_SPAN where none): [(start, end,
    name)] in order."""
    edges = []
    for k, s in enumerate(spans):
        a, b = max(s["start_ns"], lo), min(s["end_ns"], hi)
        if a < b:
            edges += [(a, 1, k), (b, 0, k)]
    edges.sort()                  # at one ns, spans close before others open
    out, live, at = [], [], lo

    def inner() -> str:
        if not live:
            return NO_SPAN
        k = max(live, key=lambda k: (spans[k]["start_ns"], spans[k]["id"]))
        return spans[k]["name"]

    for t, opens, k in edges:
        if t > at:
            out.append((at, t, inner()))
            at = t
        if opens:
            live.append(k)
        else:
            live.remove(k)
    if at < hi:
        out.append((at, hi, inner()))
    return out


def idle_intervals(trace) -> list:
    """The window's ns in which no device interval is open: [(start, end)]
    in order."""
    lo, hi = trace.window
    out, at = [], lo
    for s, e in tracing.busy_intervals(trace):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def build(trace, spans: list) -> Table | None:
    lo, hi = trace.window
    spans = [s for s in spans if s["end_ns"] > lo and s["start_ns"] < hi]
    if not spans:
        return None
    segs = segments(spans, lo, hi)
    idle: dict = {}
    i = 0
    for a, b in idle_intervals(trace):
        while segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s, e, name = segs[j]
            ns = min(e, b) - max(s, a)
            idle[name] = idle.get(name, 0) + ns
            j += 1
    starts = [s for s, _, _ in segs]
    launches: dict = {}
    for t, _, name in trace.host:
        if lo <= t < hi and tracing.LAUNCH.match(name):
            inner = segs[bisect.bisect_right(starts, t) - 1][2]
            launches[inner] = launches.get(inner, 0) + 1
    count: dict = {}
    for s in spans:
        if lo <= s["start_ns"] < hi:
            count[s["name"]] = count.get(s["name"], 0) + 1
    return Table(hi - lo, idle, launches, count)


def is_stage(name: str) -> bool:
    return name.split(".")[0] in STAGE_LAYERS


def log(t: Table) -> None:
    idle = sum(t.idle_ns.values())
    staged = sum(v for k, v in t.idle_ns.items() if is_stage(k))
    rows = sorted(set(t.idle_ns) | set(t.launches),
                  key=lambda k: -t.idle_ns.get(k, 0))
    print(f"program spans: device idle {idle / 1e9:.6f} s of the "
          f"{t.window_ns / 1e9:.6f} s window; in stage spans "
          f"{100 * staged / max(idle, 1):.2f} %, outside every program "
          f"span {100 * t.idle_ns.get(NO_SPAN, 0) / max(idle, 1):.2f} %",
          file=sys.stderr)
    for k in rows:
        print(f"  {k}: idle {t.idle_ns.get(k, 0) / 1e9:.6f} s "
              f"({100 * t.idle_ns.get(k, 0) / max(idle, 1):.2f} %), "
              f"launches {t.launches.get(k, 0)}, spans {t.count.get(k, 0)}",
              file=sys.stderr)
    sys.stderr.flush()


def read(run) -> Table | None:
    """The run's table, built and logged on the first call."""
    if run.trace is None:
        return None
    if not hasattr(run, "span_table"):
        run.span_table = build(run.trace, program_spans())
        if run.span_table is not None:
            log(run.span_table)
    return run.span_table


def idle_pct(run, ops: set, names) -> float | None:
    """The window's share (%) in which the device sat idle while the
    innermost program span was one of `names`."""
    t = read(run) if run.mix["op"] in ops else None
    if t is None:
        return None
    return 100.0 * sum(t.idle_ns.get(n, 0) for n in names) / t.window_ns


def launches_per_span(run, ops: set, names, per: str) -> float | None:
    """Launch calls made while the innermost span was one of `names`, per
    span named `per` in the window."""
    t = read(run) if run.mix["op"] in ops else None
    if t is None or not t.count.get(per):
        return None
    return sum(t.launches.get(n, 0) for n in names) / t.count[per]


def count_pct(run, ops: set, name: str, per: str) -> float | None:
    """Spans named `name` per span named `per` in the window (%)."""
    t = read(run) if run.mix["op"] in ops else None
    if t is None or not t.count.get(per):
        return None
    return 100.0 * t.count.get(name, 0) / t.count[per]
