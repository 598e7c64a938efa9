"""The JAX package's round-1 member (jx/pipeline.compress_device) as the
reference of the port's round-1 tests, and the one place the port departs
from it: a fixed block's literal/length codes.

The JAX pipeline codes a fixed block with the canonical codes of the first
286 fixed lengths; a decoder builds them from all 288, and the two differ
for literals 144-255, so zlib rejects such a JAX block.  The port codes
them from the full table (device/pipeline._plan_codes).  `repaired=True`
runs the JAX pipeline with that one change (its canonical_codes given the
full table's codes for the 286 fixed lengths; no other lengths are those:
a built Huffman code is complete, the cut fixed table is not)."""

import zlib

import numpy as np

from flate_tpu import tables as j_tables
from flate_tpu.containers import Container as JContainer
from flate_tpu.jx import pipeline as j_pl

WBITS = {"gzip": 31, "zlib": 15, "raw": -15}


def jax_round1(data: bytes, container, repaired: bool = False,
               **kw) -> bytes:
    jc = JContainer(container.value)
    if not repaired:
        return j_pl.compress_device(data, container=jc, **kw)
    plain = j_tables.canonical_codes
    fixed_ll = j_tables.FIXED_LITLEN_LENS[:286]

    def codes(lens):
        lens = np.asarray(lens)
        if lens.shape == fixed_ll.shape and np.array_equal(lens, fixed_ll):
            return j_tables.FIXED_LITLEN_CODES[:286].copy()
        return plain(lens)

    j_tables.canonical_codes = codes
    try:
        return j_pl.compress_device(data, container=jc, **kw)
    finally:
        j_tables.canonical_codes = plain


def decodes(blob: bytes, data: bytes, container) -> bool:
    try:
        return zlib.decompress(blob, WBITS[container.value]) == data
    except zlib.error:
        return False


def assert_round1_member(got: bytes, data: bytes, container, **kw) -> bool:
    """got equals the JAX package's member, or, where that member does not
    decode, the repaired JAX member of the same length; got decodes with
    zlib.  Returns whether the JAX member decoded."""
    want = jax_round1(data, container, **kw)
    assert decodes(got, data, container)
    if decodes(want, data, container):
        assert got == want
        return True
    assert got == jax_round1(data, container, repaired=True, **kw)
    assert len(got) == len(want)
    return False
