"""CRC32 / Adler32 combine math and tables (host side).

CRC32 is linear over GF(2): crc(A || B) = shift(crc(A), len(B)) ^ crc(B),
so shards are checksummed on the device independently and combined here
with the byte-shift operator (a 32x32 GF(2) matrix power).
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

ADLER_MOD = 65521
CRC_POLY = 0xEDB88320  # reflected CRC-32 (IEEE 802.3)


def crc32(data: bytes, value: int = 0) -> int:
    """Running CRC-32 of host bytes (the decoder's footer check)."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


def adler32(data: bytes, value: int = 1) -> int:
    """Running Adler-32 of host bytes (the decoder's footer check)."""
    return zlib.adler32(data, value) & 0xFFFFFFFF


def _gf2_matrix_times(mat, vec: int) -> int:
    total = 0
    i = 0
    while vec:
        if vec & 1:
            total ^= int(mat[i])
        vec >>= 1
        i += 1
    return total


def _gf2_matrix_square(mat: np.ndarray) -> np.ndarray:
    return np.array([_gf2_matrix_times(mat, int(v)) for v in mat],
                    dtype=np.uint64)


def _crc_shift_operator() -> np.ndarray:
    """Matrix applying one zero *bit* to a CRC register."""
    mat = np.zeros(32, dtype=np.uint64)
    mat[0] = CRC_POLY
    row = 1
    for i in range(1, 32):
        mat[i] = row
        row <<= 1
    return mat


@functools.lru_cache(maxsize=256)
def _crc_shift_cols(len2: int) -> tuple:
    """Columns of the finalized-crc shift-by-len2-zero-bytes operator
    (crc32_combine(x, 0, len2) is linear in x).  Cached per length:
    shards of one stream mostly share a length."""
    op = _crc_shift_operator()                 # shift by 1 zero bit
    op = _gf2_matrix_square(op)                # 2 bits
    op = _gf2_matrix_square(op)                # 4 bits
    op = _gf2_matrix_square(op)                # 8 bits = 1 zero byte
    n = len2
    shifted_basis = [1 << i for i in range(32)]
    while n:
        if n & 1:
            shifted_basis = [_gf2_matrix_times(op, v)
                             for v in shifted_basis]
        n >>= 1
        if n:
            op = _gf2_matrix_square(op)
    return tuple(shifted_basis)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concatenated streams given the two CRCs and the 2nd length."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    cols = _crc_shift_cols(len2)
    y = 0
    i = 0
    while crc1:
        if crc1 & 1:
            y ^= cols[i]
        crc1 >>= 1
        i += 1
    return (y ^ crc2) & 0xFFFFFFFF


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """Adler32 of concatenated streams."""
    rem = len2 % ADLER_MOD
    s1_1, s2_1 = ad1 & 0xFFFF, (ad1 >> 16) & 0xFFFF
    s1_2, s2_2 = ad2 & 0xFFFF, (ad2 >> 16) & 0xFFFF
    s1 = (s1_1 + s1_2 - 1) % ADLER_MOD
    s2 = (s2_1 + s2_2 + rem * (s1_1 - 1)) % ADLER_MOD
    return ((s2 << 16) | s1) & 0xFFFFFFFF


def _crc_base_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(CRC_POLY), t >> 1)
    return t


CRC_TABLE = _crc_base_table()
