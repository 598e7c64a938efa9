"""Text: RFC 1951 repeated, starting at an offset set by the seed.

A stand-in for logs and prose.  A frozen copy of bench.py's
`text_corpus`, which is this corpus at offset 0."""

from . import rfc1951


def make(size: int, seed: int) -> bytes:
    t = rfc1951()
    off = seed % len(t)
    return (t * (size // len(t) + 2))[off:off + size]
