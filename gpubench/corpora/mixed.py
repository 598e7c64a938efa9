"""Tar-like mixed data: 64 KiB of RFC 1951 text, then 16 KiB of random
bytes drawn from the seed, repeated.

A stand-in for a tarball of text and already-compressed members.  A frozen
copy of bench.py's `mixed_corpus`, which is this corpus at seed 11."""

import numpy as np

from . import text


def make(size: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    t = text.make(1 << 16, 0)
    blocks = []
    n = 0
    while n < size:
        blocks.append(t)
        r = rng.integers(0, 256, 1 << 14, dtype=np.uint8).tobytes()
        blocks.append(r)
        n += len(t) + len(r)
    return b"".join(blocks)[:size]
