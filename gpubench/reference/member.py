"""The check of a compressed member against the bytes it was made from.

check_member reads the container the configuration names (gzip with or
without the FLT1 shard index, zlib or raw), decodes the body with the
plain decoder and counts what is wrong: output bytes that differ from the
input (`bytes_wrong`) and framing that disagrees with it (`framing_errors`:
header, index, checksum, size).  With an FLT1 index, shard i is decoded
from its own first byte with the input's 32 KiB before it as history; it
has to give exactly shard i's input and end exactly where shard i + 1
starts, without a final block before the last shard.  Decoded so, every
shard is what a serial decode of the whole body meets, so the member is
proven shard by shard, which lets the shards be decoded in parallel."""

from __future__ import annotations

import struct

import numpy as np

from .checksums import adler32, crc32
from .inflate import WINDOW, DeflateError, inflate

INDEX_ID = b"FT"


def bytes_wrong(got: bytes, want: bytes) -> int:
    """Bytes of `want` that `got` does not hold at the same offset, plus
    the bytes `got` has beyond it."""
    if got == want:
        return 0
    n = min(len(got), len(want))
    diff = int(np.count_nonzero(np.frombuffer(got, np.uint8, n)
                                != np.frombuffer(want, np.uint8, n)))
    return diff + abs(len(got) - len(want))


def gzip_header(m: bytes) -> tuple[int, bytes | None]:
    """(offset of the body, the EXTRA field or None); raises ValueError
    for a header RFC 1952 does not allow."""
    if len(m) < 18 or m[:3] != b"\x1f\x8b\x08":
        raise ValueError("not a gzip member with CM = 8")
    flg = m[3]
    if flg & 0xE0:
        raise ValueError("reserved FLG bits set")
    pos, extra = 10, None
    if flg & 4:
        (xlen,) = struct.unpack_from("<H", m, pos)
        extra = m[pos + 2:pos + 2 + xlen]
        pos += 2 + xlen
    for bit in (8, 16):                 # FNAME, FCOMMENT: zero-terminated
        if flg & bit:
            end = m.index(b"\x00", pos)
            pos = end + 1
    if flg & 2:
        pos += 2
    return pos, extra


def flt1_index(extra: bytes | None):
    """(compressed lengths, output lengths) of the FLT1 subfield (u8
    version 1, u8 flags, u16 n, then n pairs of u32), or None."""
    pos = 0
    while extra is not None and pos + 4 <= len(extra):
        si = extra[pos:pos + 2]
        (ln,) = struct.unpack_from("<H", extra, pos + 2)
        body = extra[pos + 4:pos + 4 + ln]
        pos += 4 + ln
        if si != INDEX_ID or len(body) < 4:
            continue
        ver, _, n = struct.unpack_from("<BBH", body, 0)
        if ver != 1 or len(body) != 4 + 8 * n:
            continue
        pairs = struct.unpack_from(f"<{2 * n}I", body, 4)
        return list(pairs[0::2]), list(pairs[1::2])
    return None


def decode_shard(args) -> tuple[int, str | None]:
    """One shard: (its body bytes, the input before it, its input, whether
    it is the last) -> (bytes wrong, the error or None).  A shard that
    does not decode counts all its bytes wrong."""
    piece, history, want, last = args
    try:
        got, pos, _ = inflate(piece, history,
                              None if last else 8 * len(piece))
        if last and (pos + 7) // 8 != len(piece):
            raise DeflateError(f"final block ends at byte {(pos + 7) // 8} "
                               f"of {len(piece)}")
    except DeflateError as e:
        return max(len(want), 1), str(e)
    return bytes_wrong(got, want), None


def check_member(member: bytes, data: bytes, container: str,
                 index: bool, mapper=map) -> dict:
    """Counts of what is wrong in `member` as the `container` encoding of
    `data`; `index`: the member has to carry the FLT1 index.  `mapper`
    maps decode_shard over the shards (a process pool's imap)."""
    res = {"bytes_wrong": 0, "framing_errors": 0, "first_error": None}

    def framing(msg):
        res["framing_errors"] += 1
        res["first_error"] = res["first_error"] or msg

    try:
        if container == "gzip":
            start, extra = gzip_header(member)
            body, tail = member[start:-8], member[-8:]
            crc, size = struct.unpack("<II", tail)
            if crc != crc32(data):
                framing("CRC-32 in the trailer is not the input's")
            if size != len(data) & 0xFFFFFFFF:
                framing("ISIZE in the trailer is not the input's")
            shards = flt1_index(extra)
        elif container == "zlib":
            cmf, flg = member[0], member[1]
            if cmf & 15 != 8 or cmf >> 4 > 7 or (cmf << 8 | flg) % 31 \
                    or flg & 0x20:
                raise ValueError("not a zlib header without a dictionary")
            body = member[2:-4]
            if struct.unpack(">I", member[-4:])[0] != adler32(data):
                framing("Adler-32 in the trailer is not the input's")
            shards = None
        else:
            body, shards = member, None
    except (ValueError, IndexError, struct.error) as e:
        res["framing_errors"] += 1
        res["first_error"] = f"container: {e}"
        res["bytes_wrong"] = len(data)
        return res

    if index and shards is None:
        framing("no FLT1 index")
    if shards is not None:
        comp, outs = shards
        if sum(comp) != len(body) or sum(outs) != len(data) or not comp:
            framing("FLT1 index does not cover the body and the input")
            shards = None
    if shards is None:
        jobs = [(body, b"", data, True)]
    else:
        jobs, c, o = [], 0, 0
        for i, (cl, ol) in enumerate(zip(*shards)):
            jobs.append((body[c:c + cl], data[max(0, o - WINDOW):o],
                         data[o:o + ol], i == len(comp) - 1))
            c += cl
            o += ol
    for wrong, err in mapper(decode_shard, jobs):
        res["bytes_wrong"] += wrong
        if err and res["first_error"] is None:
            res["first_error"] = f"body: {err}"
    return res
