"""LSB-first bit packing on the host: the stream the round-1 encoder splices.

The port's copy of flate_tpu/bitpack.py (pack_bits_np :25, BitSink :71).
Given per-field (value, nbits):

    off  = exclusive_cumsum(nbits)          # bit offset of each field
    word = off >> 5 ; sh = off & 31         # u32 word + intra-word shift
    out  = scatter-add of the value's <= 3 u32 parts at word + {0, 1, 2}

Bits of distinct fields are disjoint, so the add is an OR; the words'
little-endian bytes are DEFLATE's LSB-first bit order.
"""

from __future__ import annotations

import numpy as np

from .errors import UnfinishedBits

MASK32 = np.uint64(0xFFFFFFFF)


def pack_bits_np(values: np.ndarray, nbits: np.ndarray,
                 bit_offset: int = 0) -> tuple[np.ndarray, int]:
    """Pack (values, nbits) fields LSB-first after `bit_offset` zero bits.
    values < 2**nbits, nbits <= 48 (0 skips the field).  Returns (u32
    words, total_bits) with total_bits counting the offset."""
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    if values.size == 0:
        return np.zeros(1, dtype=np.uint32), bit_offset
    off = bit_offset + np.concatenate([[0], np.cumsum(nbits)[:-1]])
    total_bits = int(bit_offset + nbits.sum())
    # +2 slack words: every field scatters into 3 consecutive slots even
    # when the high parts are zero
    nwords = (total_bits + 31) // 32 + 2
    out = np.zeros(nwords, dtype=np.uint64)

    word = (off >> 5).astype(np.int64)
    sh = (off & 31).astype(np.uint64)

    c0 = values & MASK32
    c1 = values >> np.uint64(32)
    v0 = (c0 << sh) & MASK32
    v1 = ((c0 >> (np.uint64(32) - sh)) | (c1 << sh)) & MASK32
    v2 = c1 >> (np.uint64(32) - sh)

    np.add.at(out, word, v0)
    np.add.at(out, word + 1, v1)
    np.add.at(out, word + 2, v2)
    return (out & MASK32).astype(np.uint32), total_bits


class BitSink:
    """A bit stream built from packed appends: fields, pre-packed word
    runs, byte alignment and byte-aligned passthrough (stored payloads).
    State between appends: the finished bytes and the partial byte."""

    def __init__(self) -> None:
        self._done = bytearray()
        self._partial = 0      # bits of the unfinished byte (value)
        self._npartial = 0     # how many bits of _partial are valid

    @property
    def bit_length(self) -> int:
        return len(self._done) * 8 + self._npartial

    def append_fields(self, values: np.ndarray, nbits: np.ndarray) -> None:
        if len(np.atleast_1d(values)) == 0:
            return
        words, total_bits = pack_bits_np(values, nbits, self._npartial)
        if self._npartial:
            words[0] |= np.uint32(self._partial)
        raw = words.astype("<u4").tobytes()
        full_bytes = total_bits // 8
        self._done += raw[:full_bytes]
        rem = total_bits - full_bytes * 8
        self._partial = raw[full_bytes] if rem else 0
        self._npartial = rem

    def append_packed(self, words: np.ndarray, total_bits: int) -> None:
        """Append a packed bit run (u32 words LSB-first, zero past
        total_bits)."""
        if total_bits == 0:
            return
        if self._npartial == 0:
            raw = words.astype("<u4").tobytes()
            full = total_bits // 8
            self._done += raw[:full]
            rem = total_bits - full * 8
            self._partial = raw[full] if rem else 0
            self._npartial = rem
            return
        # a bit-shift splice: the whole run moves left by _npartial bits
        w = words.astype(np.uint64)
        sh = np.uint64(self._npartial)
        shifted = np.zeros(w.size + 1, dtype=np.uint64)
        shifted[:-1] = (w << sh) & MASK32
        carry = w >> (np.uint64(32) - sh)
        shifted[1:] |= carry
        shifted[0] |= np.uint64(self._partial)
        nb = self._npartial + total_bits
        self._partial = 0
        self._npartial = 0
        raw = (shifted & MASK32).astype("<u4").tobytes()
        full = nb // 8
        self._done += raw[:full]
        rem = nb - full * 8
        self._partial = raw[full] if rem else 0
        self._npartial = rem

    def align_to_byte(self) -> None:
        """Pad with zero bits to the next byte boundary."""
        if self._npartial:
            self._done.append(self._partial)
            self._partial = 0
            self._npartial = 0

    def append_bytes(self, data: bytes) -> None:
        """Byte-aligned passthrough (stored-block payloads); raises
        UnfinishedBits off a byte boundary."""
        if self._npartial:
            raise UnfinishedBits("append_bytes requires byte alignment")
        self._done += data

    def getvalue(self) -> bytes:
        """The byte stream so far, its partial byte zero-padded."""
        out = bytes(self._done)
        if self._npartial:
            out += bytes([self._partial])
        return out
