"""Library-level metrics: GB/s and per-op accounting from the library
itself.

Nothing is recorded unless enabled: `flate_tpu_torch.metrics.enable()`,
or `FLATE_TPU_METRICS=1` in the environment (`=log` also prints one line
per operation to stderr).  The public entry points and the device paths
record (op, bytes_in, bytes_out, seconds) under the JAX package's op
names: `{gzip,zlib,raw}.compress` / `.decompress` in api.py,
`device.compress` in device/pipeline2.compress_device2,
`device.decompress_indexed` (a member with the FLT1 index) and
`device.decompress_any` (a member decoded as chains of blocks).
`summary()` aggregates per op: calls, byte totals and GB/s.

    >>> import flate_tpu_torch as ftt
    >>> ftt.metrics.enable()
    >>> ftt.gzip.decompress(blob)
    >>> ftt.metrics.summary()["gzip.decompress"]["gbps"]

An op's seconds are host time around a call that returns its bytes on
the host, so they include the device's work.

Spans name the stages inside a call: `span(name, **attrs)` around each
stage of an encode batch, an indexed decode batch, a chained round and a
streaming step (`encode.squeeze`, `decode.plan`, `chain.round`, ...; the
names are `<layer>.<stage>`), and `timed()` opens one under its op name,
so a public call is the root of its stages.  They record while metrics
are enabled or while a torch.profiler is recording, and cost a flag test
or two otherwise.  `spans()` returns them: name, start_ns and end_ns on
the clock of `time.time_ns()`, which is the clock of the profiler's host
events (so spans lie over a trace's device timeline), id, parent (the
enclosing span's id, None for a root), call (the root's id) and attrs.
The newest SPAN_CAP are kept; `spans_dropped()` counts those dropped.
A span is host bookkeeping only: it puts nothing on a trace.
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import threading
import time
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler

_lock = threading.Lock()
_records: list = []
_enabled = False
_log = False

SPAN_CAP = 1 << 14               # spans kept, the newest
_spans: collections.deque = collections.deque(maxlen=SPAN_CAP)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()       # .stack: the thread's open spans
_profiling = torch._C._autograd._profiler_enabled


def enable(log: bool = False) -> None:
    global _enabled, _log
    _enabled = True
    _log = log


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    global _dropped
    with _lock:
        _records.clear()
        _spans.clear()
        _dropped = 0


_env = os.environ.get("FLATE_TPU_METRICS", "")
if _env:
    enable(log=_env == "log")


def enabled() -> bool:
    return _enabled


def record(op: str, bytes_in: int, bytes_out: int, seconds: float,
           **detail) -> None:
    if not _enabled:
        return
    r = {"op": op, "bytes_in": bytes_in, "bytes_out": bytes_out,
         "seconds": seconds, **detail}
    with _lock:
        _records.append(r)
    if _log:
        n = max(bytes_in, bytes_out)
        gbps = n / seconds / 1e9 if seconds > 0 else float("inf")
        print(f"[flate_tpu_torch] {op}: {bytes_in}B -> {bytes_out}B "
              f"in {seconds * 1e3:.1f} ms ({gbps:.3f} GB/s)",
              file=sys.stderr)


@contextmanager
def timed(op: str, bytes_in: int = 0, **detail):
    """Context manager: times the block and records on exit.  The body
    may set `box['bytes_out']` (and extra detail keys) before leaving.
    The block is also a span named `op`."""
    with span(op, bytes_in=bytes_in, **detail):
        if not _enabled:
            yield {}
            return
        box: dict = {}
        t0 = time.perf_counter()
        try:
            yield box
        finally:
            dt = time.perf_counter() - t0
            out = box.pop("bytes_out", 0)
            record(op, bytes_in, out, dt, **{**detail, **box})


class _Span:
    """An open span; entered, it is on its thread's stack."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> dict:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.call = up.call if up else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self.attrs

    def __exit__(self, kind, value, tb) -> None:
        end = time.time_ns()
        stack = _local.stack
        if stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if kind is not None:
            self.attrs["error"] = kind.__name__
        rec = {"name": self.name, "start_ns": self.start_ns, "end_ns": end,
               "id": self.id, "parent": self.parent, "call": self.call,
               "attrs": self.attrs}
        global _dropped
        with _lock:
            if len(_spans) == _spans.maxlen:
                _dropped += 1
            _spans.append(rec)


class _Off:
    """The span when nothing records."""

    def __enter__(self) -> dict:
        return {}

    def __exit__(self, kind, value, tb) -> None:
        return None


_OFF = _Off()


def span(name: str, **attrs):
    """Context manager: a span of the block, recorded on exit when metrics
    are enabled or a torch.profiler is recording (else nothing).  Entered,
    it gives its attrs dict, to which the block may add."""
    if _enabled or _profiler._is_profiler_enabled or _profiling():
        return _Span(name, attrs)
    return _OFF


def spans() -> list:
    """Copies of the recorded spans, by start (the oldest dropped past
    SPAN_CAP)."""
    with _lock:
        out = [{**r, "attrs": dict(r["attrs"])} for r in _spans]
    return sorted(out, key=lambda r: (r["start_ns"], r["id"]))


def spans_dropped() -> int:
    """Spans dropped since the last reset, oldest first, past SPAN_CAP."""
    return _dropped


def records() -> list:
    with _lock:
        return list(_records)


def summary() -> dict:
    """Aggregate records: per-op {calls, bytes_in, bytes_out, seconds,
    gbps} where gbps uses max(bytes_in, bytes_out) — the stream side
    that represents the work done."""
    agg: dict = {}
    with _lock:
        rs = list(_records)
    for r in rs:
        a = agg.setdefault(r["op"], {"calls": 0, "bytes_in": 0,
                                     "bytes_out": 0, "seconds": 0.0})
        a["calls"] += 1
        a["bytes_in"] += r["bytes_in"]
        a["bytes_out"] += r["bytes_out"]
        a["seconds"] += r["seconds"]
    for a in agg.values():
        n = max(a["bytes_in"], a["bytes_out"])
        a["gbps"] = round(n / a["seconds"] / 1e9, 6) if a["seconds"] \
            else 0.0
    return agg
