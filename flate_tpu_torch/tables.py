"""RFC 1951 code tables as numpy arrays (RFC 1951 §3.2.5-3.2.6).

The port's copy of the tables the device encoders and the host block
writer (block.py) need; tests hold them equal to `flate_tpu.tables` value
for value.
"""

import numpy as np

from . import consts

# (extra_bits, base_length) per length code index 0..28 (code = 257 + index)
_LENGTH_CODE_DEFS = [
    (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 9), (0, 10),
    (1, 11), (1, 13), (1, 15), (1, 17),
    (2, 19), (2, 23), (2, 27), (2, 31),
    (3, 35), (3, 43), (3, 51), (3, 59),
    (4, 67), (4, 83), (4, 99), (4, 115),
    (5, 131), (5, 163), (5, 195), (5, 227),
    (0, 258),
]

LENGTH_EXTRA_BITS = np.array([e for e, _ in _LENGTH_CODE_DEFS], dtype=np.int32)
LENGTH_BASE = np.array([b for _, b in _LENGTH_CODE_DEFS], dtype=np.int32)

# length (3..258) -> length code index (0..28); index by length - 3
LENGTH_TO_CODE = np.zeros(256, dtype=np.int32)
for _i, (_e, _b) in enumerate(_LENGTH_CODE_DEFS):
    _hi = 259 if _i == 28 else _LENGTH_CODE_DEFS[_i + 1][1]
    LENGTH_TO_CODE[_b - 3:_hi - 3] = _i
LENGTH_TO_CODE[258 - 3] = 28  # length 258 uses code 285 (0 extra bits)

# (extra_bits, base_distance) per distance code 0..29
_DIST_CODE_DEFS = [
    (0, 1), (0, 2), (0, 3), (0, 4),
    (1, 5), (1, 7),
    (2, 9), (2, 13),
    (3, 17), (3, 25),
    (4, 33), (4, 49),
    (5, 65), (5, 97),
    (6, 129), (6, 193),
    (7, 257), (7, 385),
    (8, 513), (8, 769),
    (9, 1025), (9, 1537),
    (10, 2049), (10, 3073),
    (11, 4097), (11, 6145),
    (12, 8193), (12, 12289),
    (13, 16385), (13, 24577),
]

DIST_EXTRA_BITS = np.array([e for e, _ in _DIST_CODE_DEFS], dtype=np.int32)
DIST_BASE = np.array([b for _, b in _DIST_CODE_DEFS], dtype=np.int32)


def _dist_to_code_table() -> np.ndarray:
    """distance (1..32768) -> distance code, as a dense table indexed d-1."""
    t = np.zeros(consts.MAX_DISTANCE, dtype=np.int32)
    for i, (e, b) in enumerate(_DIST_CODE_DEFS):
        hi = consts.MAX_DISTANCE + 1 if i == 29 else _DIST_CODE_DEFS[i + 1][1]
        t[b - 1:hi - 1] = i
    return t


DIST_TO_CODE = _dist_to_code_table()

# Fixed Huffman code lengths (RFC 1951 §3.2.6).
FIXED_LITLEN_LENS = np.concatenate([
    np.full(144, 8), np.full(112, 9), np.full(24, 7), np.full(8, 8),
]).astype(np.int32)          # 288 entries
FIXED_DIST_LENS = np.full(consts.NUM_DIST_CODES, 5, dtype=np.int32)

CODEGEN_ORDER = np.array(consts.CODEGEN_ORDER, dtype=np.int32)


def reverse_bits(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Bit-reverse each code within its own length (canonical codes are
    MSB-first; DEFLATE's bitstream is LSB-first)."""
    codes = codes.astype(np.uint32)
    out = np.zeros_like(codes)
    work = codes.copy()
    for _ in range(consts.MAX_CODE_BITS):
        out = (out << 1) | (work & 1)
        work = work >> 1
    return (out >> (consts.MAX_CODE_BITS - lens).astype(np.uint32)) * (lens > 0)


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Canonical Huffman codes from code lengths (RFC 1951 §3.2.2), already
    bit-reversed for LSB-first emission.  Returns uint32 codes."""
    lens = np.asarray(lens, dtype=np.int64)
    max_bits = int(lens.max()) if lens.size else 0
    if max_bits == 0:
        return np.zeros(lens.shape, dtype=np.uint32)
    bl_count = np.bincount(lens, minlength=max_bits + 1).astype(np.uint64)
    bl_count[0] = 0
    first = np.zeros(max_bits + 1, dtype=np.uint64)
    code = np.uint64(0)
    for bits in range(1, max_bits + 1):
        code = (code + bl_count[bits - 1]) << np.uint64(1)
        first[bits] = code
    # rank within the length class, in symbol order (stable argsort)
    order = np.argsort(lens, kind="stable")
    ranked = np.empty(lens.size, dtype=np.int64)
    ranked[order] = np.arange(lens.size)
    zeros = int((lens == 0).sum())
    cum_before = np.zeros(max_bits + 2, dtype=np.int64)
    cum_before[2:] = np.cumsum(bl_count[1:].astype(np.int64))
    rank_in_class = ranked - zeros - cum_before[np.maximum(lens, 1)]
    codes = np.where(
        lens > 0,
        first[np.maximum(lens, 1)] + rank_in_class.astype(np.uint64),
        0).astype(np.uint32)
    return reverse_bits(codes, lens.astype(np.int32))


FIXED_LITLEN_CODES = canonical_codes(FIXED_LITLEN_LENS)
FIXED_DIST_CODES = canonical_codes(FIXED_DIST_LENS)
