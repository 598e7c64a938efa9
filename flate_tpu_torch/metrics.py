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
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager

_lock = threading.Lock()
_records: list = []
_enabled = False
_log = False


def enable(log: bool = False) -> None:
    global _enabled, _log
    _enabled = True
    _log = log


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    with _lock:
        _records.clear()


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
    may set `box['bytes_out']` (and extra detail keys) before leaving."""
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
