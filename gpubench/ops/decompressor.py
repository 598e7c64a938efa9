"""Streaming decompress: `<container>.decompressor(io.BytesIO(stream))`
read `read_bytes` at a time until it returns b"", on the stream of each
pool input in turn, made at set-up by the configuration's producer; the
answer is the chunks read and the decompressor's `stats`.

Checked once the window has closed: every answer of the window equals its
input (bytes_wrong); each call's peak input held and peak output held stay
within the bounds the configuration states (input_peak, and output_peak:
the cap plus the read); and the stream of input 0 with one bit of its
stored checksum flipped raises the container's checksum error
(checksum_missed).  The control decodes in windows of the configuration's
`control_window` bytes, which gives the input bound up."""

from __future__ import annotations

import io

from . import make_stream, namespace, output_checks, probe_checksum


def prepare(prog, cfg, mix, inputs, device, control):
    return {"ns": namespace(prog, cfg), "device": device, "cfg": cfg,
            "read": mix["read_bytes"],
            "window": cfg["control_window"] if control else None,
            "streams": [make_stream(prog, cfg, d, device) for d in inputs]}


def _read(state, stream):
    d = state["ns"].decompressor(io.BytesIO(stream), device=state["device"])
    if state["window"]:
        d.WINDOW = state["window"]
    parts = []
    while chunk := d.read(state["read"]):
        parts.append(chunk)
    return parts, dict(d.stats)


def call(state, k):
    return _read(state, state["streams"][k])


def sizes(state, k, answer):
    return len(state["streams"][k]), sum(map(len, answer[0]))


def after_window(state):
    return {"checksum_missed": probe_checksum(
        lambda s: _read(state, s), state["streams"][0],
        state["cfg"]["container"])}


def check(cfg, mix, inputs, calls, after, seed):
    ok = [c.answer[1] for c in calls if c.error is None]
    bound = cfg["guarantees"]
    return {**output_checks(inputs, calls, lambda a: b"".join(a[0])),
            "checksum_missed": (after["checksum_missed"], 0),
            "input_peak": (max((s["input_peak"] for s in ok), default=0),
                           bound["input_peak_bytes"]),
            "output_peak": (max((s["output_peak"] for s in ok), default=0),
                            bound["output_cap_bytes"] + mix["read_bytes"])}
