"""A plain DEFLATE decoder (RFC 1951), written for clarity before speed.

inflate(data, history, stop_bit) decodes blocks from bit 0 of `data`, with
`history` as the bytes before them, until a final block ends or, with
`stop_bit`, until a block ends exactly at that bit.  Any departure from
RFC 1951 raises DeflateError.
"""

from __future__ import annotations

LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
             4, 4, 4, 5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
              9, 10, 10, 11, 11, 12, 12, 13, 13)
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
WINDOW = 32768
OVERRUN = "the stream runs off the end of the data"


class DeflateError(ValueError):
    """The bits are not a DEFLATE stream the way RFC 1951 defines one."""


def table(lengths) -> tuple[list, int]:
    """Decode table of canonical Huffman code lengths: entry i, for the
    next `width` bits i of the stream (first bit lowest), is
    symbol << 4 | code length, or 0 where no code starts (an incomplete
    code).  An over-subscribed code raises."""
    width = max(lengths)
    if width == 0:
        return [0], 0
    count = [0] * 16
    for ln in lengths:
        count[ln] += 1
    count[0] = 0
    left = 1
    for ln in range(1, 16):
        left = 2 * left - count[ln]
        if left < 0:
            raise DeflateError("over-subscribed code")
    nxt = [0] * 16
    code = 0
    for ln in range(1, 16):
        code = (code + count[ln - 1]) << 1
        nxt[ln] = code
    t = [0] * (1 << width)
    for sym, ln in enumerate(lengths):
        if ln == 0:
            continue
        c = nxt[ln]
        nxt[ln] += 1
        rev = int(format(c, f"0{ln}b")[::-1], 2)
        t[rev::1 << ln] = [sym << 4 | ln] * (1 << (width - ln))
    return t, width


FIXED_LIT = table([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)
FIXED_DIST = table([5] * 32)


def inflate(data: bytes, history: bytes = b"",
            stop_bit: int | None = None) -> tuple[bytes, int, bool]:
    """Decode `data` from bit 0 with `history` before it.  Returns (the
    decoded bytes, the bit where decoding stopped, whether it stopped after
    a final block).  Without `stop_bit` it stops after the final block;
    with it, after the block that ends at `stop_bit`, and a final block
    before that bit, or a block that runs past it, raises."""
    out = bytearray(history[-WINDOW:])
    base = len(out)
    n = len(data)
    # bit buffer, its bits, next byte; bytes past the end read as zeros,
    # and a refill at p >= n + 6 (at most 47 bits buffered) means the
    # stream has run past its last bit
    buf = cnt = p = 0
    final = False
    while True:
        if cnt < 3:
            if p >= n + 6:
                raise DeflateError(OVERRUN)
            buf |= int.from_bytes(data[p:p + 6], "little") << cnt
            p += 6
            cnt += 48
        final = bool(buf & 1)
        kind = (buf >> 1) & 3
        buf >>= 3
        cnt -= 3
        if kind == 0:                   # stored: to the byte, LEN, NLEN
            q = (8 * p - cnt + 7) >> 3
            buf = cnt = 0
            if q + 4 > n:
                raise DeflateError("stored block header runs off the end")
            ln = data[q] | data[q + 1] << 8
            if ln ^ (data[q + 2] | data[q + 3] << 8) != 0xFFFF:
                raise DeflateError("stored block LEN != ~NLEN")
            if q + 4 + ln > n:
                raise DeflateError("stored block runs off the end")
            out += data[q + 4:q + 4 + ln]
            p = q + 4 + ln
        elif kind == 3:
            raise DeflateError("block type 3")
        else:
            if kind == 1:
                (lit, lw), (dist, dw) = FIXED_LIT, FIXED_DIST
            else:
                if cnt < 14:
                    if p >= n + 6:
                        raise DeflateError(OVERRUN)
                    buf |= int.from_bytes(data[p:p + 6], "little") << cnt
                    p += 6
                    cnt += 48
                hlit = (buf & 31) + 257
                hdist = (buf >> 5 & 31) + 1
                hclen = (buf >> 10 & 15) + 4
                buf >>= 14
                cnt -= 14
                if hlit > 286 or hdist > 30:
                    raise DeflateError("too many length or distance codes")
                cl = [0] * 19
                for i in range(hclen):
                    if cnt < 3:
                        if p >= n + 6:
                            raise DeflateError(OVERRUN)
                        buf |= int.from_bytes(data[p:p + 6], "little") << cnt
                        p += 6
                        cnt += 48
                    cl[CL_ORDER[i]] = buf & 7
                    buf >>= 3
                    cnt -= 3
                clt, clw = table(cl)
                if clw == 0:
                    raise DeflateError("empty code length code")
                lens: list = []
                while len(lens) < hlit + hdist:
                    if cnt < 16:
                        if p >= n + 6:
                            raise DeflateError(OVERRUN)
                        buf |= int.from_bytes(data[p:p + 6], "little") << cnt
                        p += 6
                        cnt += 48
                    e = clt[buf & ((1 << clw) - 1)]
                    if e == 0:
                        raise DeflateError("invalid code length code")
                    buf >>= e & 15
                    cnt -= e & 15
                    sym = e >> 4
                    if sym < 16:
                        lens.append(sym)
                        continue
                    if sym == 16:
                        if not lens:
                            raise DeflateError("repeat with no length")
                        rep, v = 3 + (buf & 3), lens[-1]
                        buf >>= 2
                        cnt -= 2
                    elif sym == 17:
                        rep, v = 3 + (buf & 7), 0
                        buf >>= 3
                        cnt -= 3
                    else:
                        rep, v = 11 + (buf & 127), 0
                        buf >>= 7
                        cnt -= 7
                    lens += [v] * rep
                if len(lens) > hlit + hdist:
                    raise DeflateError("code lengths run past HLIT + HDIST")
                if lens[256] == 0:
                    raise DeflateError("no end-of-block code")
                lit, lw = table(lens[:hlit])
                dist, dw = table(lens[hlit:])
            lmask, dmask = (1 << lw) - 1, (1 << dw) - 1
            while True:
                if cnt < 48:
                    if p >= n + 6:
                        raise DeflateError(OVERRUN)
                    buf |= int.from_bytes(data[p:p + 6], "little") << cnt
                    p += 6
                    cnt += 48
                e = lit[buf & lmask]
                if e == 0:
                    raise DeflateError("invalid literal/length code")
                buf >>= e & 15
                cnt -= e & 15
                sym = e >> 4
                if sym < 256:
                    out.append(sym)
                    continue
                if sym == 256:
                    break
                sym -= 257
                if sym >= 29:
                    raise DeflateError("invalid length symbol")
                length = LEN_BASE[sym]
                eb = LEN_EXTRA[sym]
                if eb:
                    length += buf & ((1 << eb) - 1)
                    buf >>= eb
                    cnt -= eb
                e = dist[buf & dmask] if dw else 0
                if e == 0:
                    raise DeflateError("invalid distance code")
                buf >>= e & 15
                cnt -= e & 15
                sym = e >> 4
                if sym >= 30:
                    raise DeflateError("invalid distance symbol")
                d = DIST_BASE[sym]
                eb = DIST_EXTRA[sym]
                if eb:
                    d += buf & ((1 << eb) - 1)
                    buf >>= eb
                    cnt -= eb
                start = len(out) - d
                if start < 0:
                    raise DeflateError("distance reaches before the history")
                if d >= length:
                    out += out[start:start + length]
                else:
                    out += (out[start:] * (length // d + 1))[:length]
        pos = 8 * p - cnt
        if pos > 8 * n:
            raise DeflateError("block runs off the end of the data")
        if stop_bit is None:
            if final:
                return bytes(out[base:]), pos, True
        elif final:
            raise DeflateError(f"final block ends at bit {pos}, before "
                               f"the stop at {stop_bit}")
        elif pos == stop_bit:
            return bytes(out[base:]), pos, False
        elif pos > stop_bit:
            raise DeflateError(f"block ends at bit {pos}, past the stop at "
                               f"{stop_bit}")
