"""Port device/scan.py (the chunk-entry scanner) against the JAX package's
host C scanner, flate_tpu/native/fastinflate.c:scan_headers, on the CPU.

The plain version must give exactly the C's offsets on every case of
tests/_torch_corpora.py:scan_cases (zlib bodies at levels 0, 1, 6, 9 and
Z_FIXED, random bytes, unaligned starts, ranges that end at a header or in
the last 96 bits, short streams, hand-built headers that hit each rejection
of the C's parse), and chunk_entries the list the JAX member loop builds
(flate_tpu/jx/anyinflate.py:365-373).  The steps the card path adds after
its kernel (_positions, _first_per_chunk) run here on CPU tensors.
Tolerance: exact (bit offsets).
"""

import zlib

import numpy as np
import pytest
import torch

from flate_tpu import native

from flate_tpu_torch import errors
from flate_tpu_torch.device import scan

from _torch_corpora import (deflate_raw, dyn_header, header_cases,
                            header_case_stream, scan_cases, trap_stream,
                            with_eob)

CASES = scan_cases()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def c_scanner():
    if not native.inflate_available():
        pytest.skip("the JAX package's native scanner is not built")
    return native


def _member_loop_entries(body: bytes, chunk_bytes: int) -> list:
    """flate_tpu/jx/anyinflate.py:365-373, the chain heads of a member."""
    entries = [0]
    nchunks = max(1, -(-len(body) // chunk_bytes))
    for k in range(1, nchunks):
        found = native.scan_headers(
            body, 8 * k * chunk_bytes, 8 * (k + 1) * chunk_bytes, max_out=1)
        if found:
            entries.append(int(found[0]))
    return entries


@pytest.mark.parametrize("name", list(CASES))
def test_scan_headers_equal_c(c_scanner, name):
    data, start, end, max_out = CASES[name]
    want = c_scanner.scan_headers(data, start, end, max_out) if data else []
    assert scan.scan_headers(data, start, end, max_out, device="cpu") == want
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.zeros(0, dtype=torch.uint8)
    assert scan.scan_headers(buf, start, end, max_out) == want


@pytest.mark.parametrize("name", list(header_cases()))
def test_header_cases_hit_their_rule(c_scanner, name):
    """Each hand-built header is accepted or rejected as its case says, by
    the C and by the port: the case reaches the rule it names."""
    accepted = header_cases()[name][1]
    data = header_case_stream(name)
    assert (13 in c_scanner.scan_headers(data, max_out=100)) == accepted
    assert (13 in scan.scan_headers(data, max_out=100,
                                    device="cpu")) == accepted


def test_cross_repeat_is_valid_rfc1951():
    """The repeat-16 case is a valid header by RFC 1951 (zlib decodes a
    block with it); only the C's separate runs reject it."""
    (ll, d, kw), _ = header_cases()["repeat16_first_dist"]
    bits = with_eob(dyn_header(ll, d, **kw), ll)
    bits += [0] * ((-len(bits)) % 8)
    raw = np.packbits(np.asarray(bits, np.uint8), bitorder="little")
    assert zlib.decompressobj(-15).decompress(raw.tobytes()) == b""


CHUNK_BODIES = {
    "text_l1": lambda: CASES["text_l1"][0],
    "mixed_l1": lambda: CASES["mixed_l1"][0],
    "mixed_l9": lambda: CASES["mixed_l9"][0],
    "fixed": lambda: CASES["fixed"][0],
    "random_64k": lambda: CASES["random_64k"][0],
    "trap": lambda: trap_stream()[2:],
    "tiny": lambda: b"\x05" * 40,
    "empty": lambda: b"",
}


@pytest.mark.parametrize("chunk", [32768, 5001])
@pytest.mark.parametrize("name", list(CHUNK_BODIES))
def test_chunk_entries_equal_member_loop(c_scanner, name, chunk):
    body = CHUNK_BODIES[name]()
    want = _member_loop_entries(body, chunk)
    assert scan.chunk_entries(body, chunk, device="cpu") == want
    if name in ("text_l1", "mixed_l1", "trap"):
        assert len(want) > 1


@pytest.mark.parametrize("chunk", [32768, 5001])
@pytest.mark.parametrize("name", ["mixed_l1", "trap", "random_64k"])
def test_card_path_selection_equal_plain(name, chunk):
    """The card path's steps after its kernel, on the CPU: the bitmap of
    every valid offset -> _positions -> _first_per_chunk gives the plain
    chunk_entries."""
    body = CHUNK_BODIES[name]()
    buf = torch.frombuffer(bytearray(body), dtype=torch.uint8)
    lo, hi = scan._range(len(body), 8 * chunk, None)
    allpos = scan._scan_plain(scan._prepare(buf), lo, hi, 1 << 30)
    lo0 = lo & ~31
    bitmap = np.zeros(-(-(hi - lo0) // 32), np.uint32)
    for p in allpos:
        bitmap[(p - lo0) >> 5] |= np.uint32(1 << ((p - lo0) & 31))
    pos = scan._positions(torch.from_numpy(bitmap.view(np.int32)), lo)
    assert pos.tolist() == allpos
    nchunks = -(-len(body) // chunk)
    assert scan._first_per_chunk(pos, nchunks, 8 * chunk) == \
        scan.chunk_entries(buf, chunk)


def test_positions_sign_bit_and_empty():
    bitmap = torch.tensor([0, -(1 << 31) | 5, 0, 1], dtype=torch.int32)
    assert scan._positions(bitmap, 70).tolist() == [96, 98, 127, 160]
    assert scan._positions(torch.zeros(3, dtype=torch.int32), 0).numel() == 0
    assert scan._first_per_chunk(torch.zeros(0, dtype=torch.int64), 5,
                                 64) == [0]


def test_stats_count_the_scan():
    """The plain version's counts: every offset up to the stop, the HCLEN
    fields of the offsets that reach the Kraft test, the headers parsed and
    the bits they read; ops_needed weighs them."""
    body = CASES["mixed_l6"][0]
    buf = torch.frombuffer(bytearray(body), dtype=torch.uint8)
    lo, hi = scan._range(len(body), 0, None)
    st = {}
    found = scan._scan_plain(scan._prepare(buf), lo, hi, 1 << 30, st)
    assert found == scan.scan_headers(buf, max_out=1 << 30)
    assert st["offsets"] == hi - lo
    bits = np.unpackbits(np.frombuffer(body, np.uint8), bitorder="little")
    p = np.arange(lo, hi)

    def field(o, n):
        return sum(bits[p + o + i].astype(np.int64) << i for i in range(n))

    reach = (field(1, 2) == 2) & (field(3, 5) <= 29) & (field(8, 5) <= 29)
    assert st["kraft_fields"] == int((field(13, 4) + 4)[reach].sum())
    assert st["parsed_bits"] > st["parsed"] >= len(found) > 1
    assert scan.ops_needed(st) == (scan.OPS_PER_OFFSET * st["offsets"]
                                   + scan.OPS_PER_KRAFT_FIELD
                                   * st["kraft_fields"]
                                   + scan.OPS_PER_PARSED_BIT
                                   * st["parsed_bits"])
    assert st["found"] == len(found) and st["parsed_bits"] > st["found_bits"]
    st1 = {}
    first = scan._scan_plain(scan._prepare(buf), lo, hi, 1, st1)
    assert first == found[:1] and st1["offsets"] == first[0] - lo + 1
    assert st1["found"] == 1
    assert scan.bytes_needed(st1) == -(-(first[0] - lo + 1 + 3
                                         + st1["found_bits"]) // 8) + 8


@pytest.mark.parametrize("chunk", [32768, 5001])
def test_chunk_stats_count_each_chunk_to_its_first_header(chunk):
    """_chunk_entries_plain's counts: each chunk k >= 1 is tested up to its
    first header (or to its end where it holds none), one header found a
    chunk that has one."""
    body = CASES["mixed_l6"][0]
    buf = torch.frombuffer(bytearray(body), dtype=torch.uint8)
    st = {}
    got = scan._chunk_entries_plain(scan._prepare(buf), len(body), chunk, st)
    assert got == scan.chunk_entries(buf, chunk)
    step = 8 * chunk
    want = 0
    for k in range(1, -(-len(body) // chunk)):
        lo, hi = scan._range(len(body), k * step, (k + 1) * step)
        heads = [p for p in got[1:] if lo <= p < hi]
        want += (heads[0] + 1 - lo) if heads else max(hi - lo, 0)
    assert st["offsets"] == want and st["found"] == len(got) - 1
    assert scan.bytes_needed(st) >= want // 8 + 8 * st["found"]


def test_scan_arguments():
    assert scan.scan_headers(b"", device="cpu") == []
    assert scan.scan_headers(CASES["mixed_l1"][0], max_out=0,
                             device="cpu") == []
    assert scan.chunk_entries(b"", 32768, device="cpu") == [0]
    with pytest.raises(ValueError):
        scan.chunk_entries(b"abc", 0, device="cpu")
    with pytest.raises(ValueError):
        scan.scan_headers(torch.zeros(4, dtype=torch.int32))


def test_scan_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is untestable")
    with pytest.raises(errors.DeviceUnavailable):
        scan.scan_headers(deflate_raw(b"abc" * 100, 6))
    with pytest.raises(errors.DeviceUnavailable):
        scan.chunk_entries(b"abc", 32768)
