"""FLT1 shard index — an RFC 1952 EXTRA subfield with per-shard boundaries.

Layout after the 4-byte subfield header: u8 version, u8 flags, u16
n_shards, then n_shards * (u32 comp_len, u32 out_len), all LE.  flags
bit 0: shards are context-independent.  Standard gzip tools ignore
EXTRA subfields (RFC 1952 §2.3.1.1).
"""

from __future__ import annotations

import struct

import numpy as np

INDEX_SI = b"FT"
INDEX_VERSION = 1
FLAG_INDEPENDENT = 1     # shards carry no cross-shard context
MAX_SHARDS = 8000        # keeps the subfield under the 64 KiB EXTRA cap


def build_index_extra(comp_lens, out_lens, flags: int = 0) -> bytes:
    n = len(comp_lens)
    if n > MAX_SHARDS:
        raise ValueError("FLT1 index: too many shards for one member")
    body = struct.pack("<BBH", INDEX_VERSION, flags, n)
    body += np.stack([np.asarray(comp_lens, np.uint32),
                      np.asarray(out_lens, np.uint32)],
                     axis=1).tobytes()
    return INDEX_SI + struct.pack("<H", len(body)) + body


def parse_index_extra(extra: bytes):
    """Find and parse the FLT1 subfield; None when absent/foreign.
    Returns (comp_lens i64, out_lens i64, flags)."""
    pos = 0
    while pos + 4 <= len(extra):
        si, ln = extra[pos:pos + 2], struct.unpack_from("<H", extra,
                                                        pos + 2)[0]
        body = extra[pos + 4:pos + 4 + ln]
        pos += 4 + ln
        if si != INDEX_SI or len(body) < 4:
            continue
        ver, flags, n = struct.unpack_from("<BBH", body, 0)
        if ver != INDEX_VERSION or len(body) != 4 + 8 * n:
            continue
        arr = np.frombuffer(body, np.uint32, count=2 * n, offset=4)
        arr = arr.reshape(n, 2)
        return (arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
                flags)
    return None
