"""The calls a mix makes, found by the mix's `op` key: module `<op>` here
defines

    prepare(prog, cfg, mix, inputs, device, control) -> state
    call(state, k) -> answer          # one call on pool input k
    sizes(state, k, answer) -> (bytes in, bytes out) of one call
    after_window(state) -> dict       # calls made once the window closed
    check(cfg, mix, inputs, calls, after, seed) -> {name: (value, limit)}

`prog` is the imported program, `inputs` the pool of inputs made from the
seed, `control` whether the run is the control (the program with one of
the configuration's guarantees given up, which the check has to fail).
Every number check returns has to be at most its limit.  What the ops
share is here."""

from __future__ import annotations

import zlib

from ..reference.member import bytes_wrong

CHECKSUM_ERRORS = ("WrongGzipChecksum", "WrongZlibChecksum")


def namespace(prog, cfg):
    """The program's API namespace of the configuration's container."""
    return getattr(prog, cfg["container"])


def make_stream(prog, cfg, data: bytes, device) -> bytes:
    """The compressed stream a decode cell reads, made by the
    configuration's producer: "port" (the program's own encoder at the
    configuration's level and shapes) or "cpython-zlib" (CPython's zlib
    module, wbits 15 and memLevel 8, as zlib.compress writes)."""
    if cfg["producer"] == "port":
        return namespace(prog, cfg).compress(
            data, level=cfg["level"], shard_len=cfg["shard_len"],
            ctx=cfg["ctx"], batch=cfg["encode_batch"], device=device)
    if cfg["producer"] == "cpython-zlib" and cfg["container"] == "zlib":
        return zlib.compress(data, cfg["level"])
    raise ValueError(f"no producer {cfg['producer']!r} of "
                     f"{cfg['container']} streams")


def corrupt_checksum(stream: bytes, container: str) -> bytes:
    """The stream with one bit of its stored checksum flipped."""
    at = len(stream) - (8 if container == "gzip" else 4)
    return stream[:at] + bytes([stream[at] ^ 1]) + stream[at + 1:]


def probe_checksum(decode, stream: bytes, container: str) -> int:
    """1 when `decode` returns, or fails otherwise than on the checksum,
    for the stream with a flipped checksum; 0 when it raises the
    container's checksum error."""
    try:
        decode(corrupt_checksum(stream, container))
    except Exception as e:   # judged by its class: anything else misses
        return 0 if type(e).__name__ in CHECKSUM_ERRORS else 1
    return 1


def output_checks(inputs, calls, output=bytes) -> dict:
    """bytes_wrong: the output bytes of every call in the window that
    differ from its input (`output` of the call's answer); calls_failed:
    calls that raised."""
    wrong = failed = 0
    for c in calls:
        if c.error is not None:
            failed += 1
            continue
        wrong += bytes_wrong(output(c.answer), inputs[c.k])
    return {"bytes_wrong": (wrong, 0), "calls_failed": (failed, 0)}
