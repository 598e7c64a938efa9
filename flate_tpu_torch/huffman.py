"""Length-limited canonical Huffman code lengths (host, encode side).

The port's copy of flate_tpu/huffman.py (:28-128): optimal Huffman depths
by a two-queue merge over the used symbols, and exact package-merge when a
depth passes the limit, in the host C library (csrc/host_encode.c
`huff_lengths`, built by _build.host_library).  Codes come from
tables.canonical_codes.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build, tables


def huffman_code_lengths(freq: np.ndarray, max_bits: int) -> np.ndarray:
    """int32 code lengths of freq under max_bits: 0 for unused symbols, 1
    for a single used symbol (and each of two), all 0 for none."""
    freq = np.ascontiguousarray(freq, dtype=np.int64)
    out = np.zeros(freq.size, dtype=np.uint8)
    rc = _build.host_library().huff_lengths(
        freq.ctypes.data_as(ctypes.c_void_p), freq.size, max_bits,
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(
            f"{int(np.count_nonzero(freq))} used of {freq.size} symbols do "
            f"not fit {max_bits}-bit codes (the host C takes at most 320 "
            f"symbols)")
    return out.astype(np.int32)


def build_codes(freq: np.ndarray, max_bits: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """freq -> (codes, lens); codes bit-reversed for LSB-first emission."""
    lens = huffman_code_lengths(freq, max_bits)
    return tables.canonical_codes(lens), lens


def bit_length(freq: np.ndarray, lens: np.ndarray) -> int:
    """Total payload bits of coding freq with these code lengths."""
    return int((np.asarray(freq, dtype=np.int64) * lens).sum())
