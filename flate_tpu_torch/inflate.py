"""Host-side DEFLATE block parsing for the device decoder.

The bit cursor, the code-length validation, the dynamic-header parser and a
pure-Python block decode loop: what the device decode needs on the host to
plan a shard (read its block header into canonical decode scalars) and to
decode, exactly, the rare shard whose lane speculation stays unproven.
Counterpart of the same functions in flate_tpu/inflate.py, with the same
strict error classes; numpy and bytes only.
"""

from __future__ import annotations

import functools

import numpy as np

from . import consts, tables
from .errors import (
    EndOfStream,
    IncompleteHuffmanTree,
    InvalidCode,
    InvalidDynamicBlockHeader,
    InvalidMatch,
    MissingEndOfBlockCode,
    OversubscribedHuffmanTree,
    WrongStoredBlockNlen,
)

# ---------------------------------------------------------------------------
# Decode table construction
# ---------------------------------------------------------------------------

def check_completeness(lens: np.ndarray, max_code_bits: int,
                       is_litlen: bool) -> None:
    """Validate a code-length set.

    - litlen alphabet must contain the end-of-block code;
    - over-subscribed sets always fail;
    - incomplete sets are allowed only for the 15-bit decoders and only in
      the single length-1-code form (the RFC's single-distance-code case);
    - the empty set is allowed.
    """
    lens = np.asarray(lens)
    if is_litlen and lens[256] == 0:
        raise MissingEndOfBlockCode()
    count = np.bincount(lens, minlength=max_code_bits + 1)
    used = count[1:].sum()
    if used == 0:
        return
    left = 1
    for ln in range(1, max_code_bits + 1):
        left <<= 1
        if count[ln] > left:
            raise OversubscribedHuffmanTree()
        left -= count[ln]
    if left > 0:
        if max_code_bits > 7 and int(lens.max()) == int(count[1]):
            return  # single length-1 code: allowed incomplete form
        raise IncompleteHuffmanTree()


def build_decode_table(lens: np.ndarray, max_code_bits: int,
                       is_litlen: bool) -> tuple[np.ndarray, np.ndarray]:
    """Build a flat 2**max_code_bits lookup: peeked (LSB-first) bits -> symbol.

    Returns (symbol[int16], nbits[int8]); symbol == -1 marks invalid codes.
    Vectorized: each code of length l fills its 2**(max-l) strided slots in
    one shot.
    """
    lens = np.asarray(lens, dtype=np.int32)
    check_completeness(lens, max_code_bits, is_litlen)
    size = 1 << max_code_bits
    sym_t = np.full(size, -1, dtype=np.int16)
    bits_t = np.zeros(size, dtype=np.int8)
    codes = tables.canonical_codes(lens)  # already bit-reversed (LSB-first)
    for s in np.nonzero(lens)[0]:
        l = int(lens[s])
        r = int(codes[s])
        idx = r + (np.arange(1 << (max_code_bits - l)) << l)
        sym_t[idx] = s
        bits_t[idx] = l
    return sym_t, bits_t


@functools.lru_cache(maxsize=1)
def fixed_tables():
    """(litlen table, distance table) of the fixed Huffman code."""
    ll = build_decode_table(
        tables.FIXED_LITLEN_LENS, consts.MAX_CODE_BITS, is_litlen=False)
    # all 32 5-bit distance codes participate so the table is complete;
    # symbols 30/31 then decode and are rejected as InvalidCode
    dd = build_decode_table(
        tables.FIXED_DIST_LENS, consts.MAX_CODE_BITS, is_litlen=False)
    return ll, dd


# ---------------------------------------------------------------------------
# Bit reader
# ---------------------------------------------------------------------------

class _BitCursor:
    """LSB-first bit cursor over a byte buffer.

    peek() zero-pads past the end; consuming past the end raises
    EndOfStream."""

    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.nbits = len(data) * 8
        self.pos = bit_pos

    def peek(self, n: int) -> int:
        byte = self.pos >> 3
        chunk = self.data[byte:byte + ((n + 7 + (self.pos & 7)) >> 3) + 1]
        v = int.from_bytes(chunk, "little") >> (self.pos & 7)
        return v & ((1 << n) - 1)

    def consume(self, n: int) -> None:
        if self.pos + n > self.nbits:
            raise EndOfStream()
        self.pos += n

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.consume(n)
        return v

    def align_to_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_bytes(self, n: int) -> bytes:
        assert self.pos % 8 == 0
        byte = self.pos >> 3
        if (byte + n) * 8 > self.nbits:
            raise EndOfStream()
        self.pos += n * 8
        return self.data[byte:byte + n]


# ---------------------------------------------------------------------------
# Core block decode
# ---------------------------------------------------------------------------

def _decode_dynamic_header(bits: _BitCursor):
    lit_lens, dst_lens = decode_dynamic_header_lens(bits)
    ll = build_decode_table(lit_lens, consts.MAX_CODE_BITS, is_litlen=True)
    dd = build_decode_table(dst_lens, consts.MAX_CODE_BITS, is_litlen=False)
    return ll, dd


def decode_dynamic_header_lens(bits: _BitCursor):
    """Dynamic block header -> (litlen lens[286], dist lens[30]).

    Shared by the host block loop and the device planner (device/inflate2);
    validation of the resulting length sets is the caller's job."""
    hlit = bits.read(5) + 257
    hdist = bits.read(5) + 1
    hclen = bits.read(4) + 4
    if hlit > 286 or hdist > 30:
        raise InvalidDynamicBlockHeader("hlit/hdist out of range")
    cl_lens = np.zeros(consts.NUM_CODEGEN, dtype=np.int32)
    for i in range(hclen):
        cl_lens[consts.CODEGEN_ORDER[i]] = bits.read(3)
    cg_sym, cg_bits = build_decode_table(cl_lens, consts.MAX_CODEGEN_BITS,
                                         is_litlen=False)

    def read_lens(count: int, arr_len: int) -> np.ndarray:
        lens = np.zeros(arr_len, dtype=np.int32)
        pos = 0
        while pos < count:
            code = bits.peek(consts.MAX_CODEGEN_BITS)
            s = int(cg_sym[code])
            if s < 0:
                raise InvalidCode()
            bits.consume(int(cg_bits[code]))
            if s < 16:
                if pos >= arr_len:
                    raise InvalidDynamicBlockHeader("code length overflow")
                lens[pos] = s
                pos += 1
            elif s == 16:
                n = bits.read(2) + 3
                if pos == 0 or pos + n > arr_len:
                    raise InvalidDynamicBlockHeader("bad repeat")
                lens[pos:pos + n] = lens[pos - 1]
                pos += n
            elif s == 17:
                pos += bits.read(3) + 3
            else:
                pos += bits.read(7) + 11
        if pos > count:
            raise InvalidDynamicBlockHeader("lengths overflow declared count")
        return lens

    lit_lens = read_lens(hlit, 286)
    dst_lens = read_lens(hdist, 30)
    return lit_lens, dst_lens


def read_symbol(bits: _BitCursor, ll_table, d_table) -> tuple:
    """Read one symbol of a coded block at the cursor: (litlen symbol,
    match length, distance), the last two 0 unless it is a match.  Raises
    what the block loop raises there, in its order: InvalidCode for a code
    the tables do not hold, EndOfStream for bits past the end (peeks read
    zeros there, consuming does not)."""
    ll_sym, ll_bits = ll_table
    d_sym, d_bits = d_table
    code = bits.peek(15)
    s = int(ll_sym[code])
    if s < 0:
        raise InvalidCode()
    bits.consume(int(ll_bits[code]))
    if s <= 256:
        return s, 0, 0
    li = s - 257
    if li > 28:
        raise InvalidCode()
    length = int(tables.LENGTH_BASE[li]) + bits.read(
        int(tables.LENGTH_EXTRA_BITS[li]))
    dcode = bits.peek(15)
    ds = int(d_sym[dcode])
    if ds < 0:
        raise InvalidCode()
    bits.consume(int(d_bits[dcode]))
    if ds > 29:
        raise InvalidCode()
    dist = int(tables.DIST_BASE[ds]) + bits.read(
        int(tables.DIST_EXTRA_BITS[ds]))
    return s, length, dist


def _decode_coded_block(bits: _BitCursor, out: bytearray,
                        ll_table, d_table) -> None:
    """The serial symbol decode loop of one coded block."""
    while True:
        s, length, dist = read_symbol(bits, ll_table, d_table)
        if s < 256:
            out.append(s)
        elif s == 256:
            return
        else:
            if dist > len(out):
                raise InvalidMatch()
            # overlapping copies replicate (LZ77 semantics)
            start = len(out) - dist
            if dist >= length:
                out += out[start:start + length]
            else:
                for i in range(length):
                    out.append(out[start + i])


def _decode_stored(bits: _BitCursor, out: bytearray) -> None:
    bits.align_to_byte()
    ln = bits.read(16)
    nlen = bits.read(16)
    if ln != (~nlen & 0xFFFF):
        raise WrongStoredBlockNlen()
    out += bits.read_bytes(ln)
