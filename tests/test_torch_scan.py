"""Port device/scan.py (the chunk-entry scanner) against the JAX package's
host C scanner, flate_tpu/native/fastinflate.c:scan_headers, on the CPU.

The plain version must give exactly the C's offsets on every case of
tests/_torch_corpora.py:scan_cases (zlib bodies at levels 0, 1, 6, 9 and
Z_FIXED, random bytes, unaligned starts, ranges that end at a header or in
the last 96 bits, short streams, hand-built headers that hit each rejection
of the C's parse), and chunk_entries the list the JAX member loop builds
(flate_tpu/jx/anyinflate.py:365-373), also on the inputs that put headers
at the kernel's tile and chunk edges.  The steps the card path adds around
its kernel (_first_per_chunk, and scan_headers' launch past each header
found) run here on CPU tensors with the kernel's state made by the plain
scan.  The card tests at the end hold scan_kernel to the plain version on
the card (marked cuda; they skip here).  Tolerance: exact (bit offsets).
"""

import time
import zlib

import numpy as np
import pytest
import torch

from flate_tpu import native

from flate_tpu_torch import errors
from flate_tpu_torch.device import scan

from _torch_corpora import (HDR_D, corpus, deflate_raw, dyn_header,
                            header_cases, header_case_stream, scan_cases,
                            scan_edge_cases, trap_stream, with_eob)

CASES = scan_cases()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_RELOADED = []


@pytest.fixture
def c_scanner():
    if not native.inflate_available() and not _RELOADED:
        # A process that loaded the library while another process was still
        # compiling it holds None from then on: load it again, once a
        # process, while the compile may still be running.
        _RELOADED.append(True)
        for _ in range(60):
            native._LIBS.pop("fastinflate", None)
            if native.inflate_available():
                break
            time.sleep(1)
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


def _plain_kernel(prep, launches: list | None = None):
    """scan_kernel's state as the plain scan gives it (on the host): ~ the
    first header of each segment, 0 for none, and the segments with one."""
    def run(buf, seg0, seg_len, hi, nseg):
        if launches is not None:
            launches.append((seg0, hi))
        firsts = []
        for k in range(nseg):
            lo = seg0 + k * seg_len
            firsts += [~f for f in scan._scan_plain(
                prep, lo, min(lo + seg_len, hi), 1)] or [0]
        return torch.tensor([0, sum(f != 0 for f in firsts), 0, 0, *firsts,
                             *[0] * nseg], dtype=torch.int64)
    return run


@pytest.mark.parametrize("chunk", [32768, 5001])
@pytest.mark.parametrize("name", ["mixed_l1", "trap", "random_64k"])
def test_card_path_selection_equal_plain(monkeypatch, name, chunk):
    """The card path's steps around its kernel, on the CPU, with a state as
    the kernel writes it: _first_per_chunk gives the plain chunk_entries,
    and scan_headers' launches past each header found give the plain
    scan_headers."""
    body = CHUNK_BODIES[name]()
    buf = torch.frombuffer(bytearray(body), dtype=torch.uint8)
    prep = scan._prepare(buf)
    monkeypatch.setattr(scan, "_scan_cuda", _plain_kernel(prep))
    step = 8 * chunk
    lo, hi = scan._range(len(body), step, None)
    assert scan._scan_from_each(buf, lo, hi, 1 << 30) == \
        scan._scan_plain(prep, lo, hi, 1 << 30) == \
        scan.scan_headers(buf, step, None, 1 << 30)
    nseg = -(-(hi - lo) // step)
    assert scan._first_per_chunk(scan._scan_cuda(buf, lo, step, hi, nseg),
                                 nseg) == scan.chunk_entries(buf, chunk)


def test_positions_sign_bit_and_empty():
    """A segment's first header is kept as its complement (u64 ~p, a
    negative int64), 0 for none; empty states."""
    assert scan._first_per_chunk(torch.tensor([0, 2, 0, 0, 0, ~70, ~(1 << 40),
                                               0, 3, 3]), 3) == [0, 70,
                                                                 1 << 40]
    assert scan._first_per_chunk(torch.zeros(4, dtype=torch.int64),
                                 0) == [0]
    assert scan._first_per_chunk(torch.zeros(6, dtype=torch.int64),
                                 1) == [0]


@pytest.mark.parametrize("max_out", [1, 4, 1000])
def test_scan_headers_card_launch_a_header(monkeypatch, max_out):
    """scan_headers on the card launches over one segment from past each
    header found: a launch a header, and one more that finds none where
    fewer than max_out are left."""
    body = CASES["mixed_l1"][0]
    buf = torch.frombuffer(bytearray(body), dtype=torch.uint8)
    prep = scan._prepare(buf)
    launches = []
    monkeypatch.setattr(scan, "_scan_cuda", _plain_kernel(prep, launches))
    lo, hi = scan._range(len(body), 0, None)
    want = scan._scan_plain(prep, lo, hi, max_out)
    assert scan._scan_from_each(buf, lo, hi, max_out) == want
    assert launches == [(lo, hi)] + [(p + 1, hi) for p in want][
        :len(want) - (len(want) == max_out)]
    assert (len(want) == max_out) == (max_out < 1000)


@pytest.mark.parametrize("name", list(scan_edge_cases()))
def test_scan_edges_equal_c(c_scanner, name):
    """The inputs that put headers at the kernel's tile and chunk edges:
    scan_headers equals the C scanner, chunk_entries the member loop."""
    data, start, end, max_out, chunks = scan_edge_cases()[name]
    assert scan.scan_headers(data, start, end, max_out, device="cpu") == \
        c_scanner.scan_headers(data, start, end, max_out)
    for chunk in chunks:
        assert scan.chunk_entries(data, chunk, device="cpu") == \
            _member_loop_entries(data, chunk)


def test_settled_bits_stop_at_an_oversubscribed_run():
    """A header whose literal/length lengths are over-subscribed by their
    third length is settled there: _settled_bits counts its fields, its
    code-length code and three code-length symbols, where the parse reads
    on to the end of its runs; a header that passes is settled at its
    end."""
    over = [1, 1, 1] + [0] * 253 + [1]
    bits = dyn_header(over, HDR_D)
    raw = np.packbits(np.asarray(bits + [0] * 64, np.uint8),
                      bitorder="little").tobytes()
    ok, nb = scan._validate(raw, 0)
    settled = scan._settled_bits(raw, 0)
    hclen = int(np.dot(bits[13:17], [1, 2, 4, 8])) + 4
    assert not ok and 14 + 3 * hclen < settled <= 14 + 3 * hclen + 3 * 7
    assert settled < nb
    data = header_case_stream("accepted")
    assert scan._validate(data, 13) == (True, scan._settled_bits(data, 13))


def test_stats_count_the_scan():
    """The plain version's counts: every offset up to the stop, the HCLEN
    fields of the offsets that reach the Kraft test, the headers parsed and
    the bits each read before its answer was settled (_settled_bits: all of
    a header found); ops_needed weighs them."""
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
    data = bytes(body)
    assert st["found_bits"] == sum(scan._validate(data, p)[1] for p in found)
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


# ---------------------------------------------------------------------------
# On the card: scan_kernel against the plain version (run without the JAX
# conftest: python -m pytest --noconftest tests/test_torch_scan.py -m cuda)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


EDGES = scan_edge_cases()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EDGES))
def test_scan_kernel_edges_equal_plain(cuda, name):
    """Headers at a tile's and a chunk's last offset, a parse that reads
    into the next chunk, a chunk without a header, max_out inside a tile,
    an end not a multiple of 32, all-zero and random bodies."""
    data, start, end, max_out, chunks = EDGES[name]
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    assert scan.scan_headers(buf.to(cuda), start, end, max_out) == \
        scan.scan_headers(buf, start, end, max_out)
    for chunk in chunks:
        assert scan.chunk_entries(buf.to(cuda), chunk) == \
            scan.chunk_entries(buf, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32768, 131072, 524288])
@pytest.mark.parametrize("name", [*CASES, "trap"])
def test_scan_kernel_cases_equal_plain(cuda, name, chunk):
    """Every scan case (hand-built headers and the trap stream among them)
    through scan_headers and chunk_entries at three chunk sizes."""
    if name == "trap":
        data, start, end, max_out = trap_stream()[2:], 0, None, 64
    else:
        data, start, end, max_out = CASES[name]
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.zeros(0, dtype=torch.uint8)
    assert scan.scan_headers(buf.to(cuda), start, end, max_out) == \
        scan.scan_headers(buf, start, end, max_out)
    assert scan.chunk_entries(buf.to(cuda), chunk) == \
        scan.chunk_entries(buf, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4096, 32768, 131072, 524288])
def test_scan_kernel_stops_at_each_chunks_first_header(cuda, chunk):
    """chunk_entries on a 7 MB level-6 body at the decode's chunk sizes
    (and at 4 KiB: more chunks than the grid has blocks, so blocks take
    further chunks from a counter) equals the plain version; the kernel
    tests every offset the list needs (those up to each chunk's first
    header) and at most a tenth of the body's offsets more (the tiles in
    flight when a chunk's first header is found)."""
    body = zlib.compress(corpus("mixed", 16 << 20, seed=4), 6)[2:]
    buf = torch.frombuffer(bytearray(body), dtype=torch.uint8)
    got = scan.chunk_entries(buf.to(cuda), chunk)
    st = {}
    assert got == scan._chunk_entries_plain(scan._prepare(buf), len(body),
                                            chunk, st)
    assert len(got) > 2
    step = 8 * chunk
    lo, hi = scan._range(len(body), step, None)
    nseg = -(-(hi - lo) // step)
    state = scan._scan_cuda(buf.to(cuda), lo, step, hi, nseg).cpu()
    assert scan._first_per_chunk(state, nseg) == got
    tested = int(state[scan.STATE_TESTED])
    assert st["offsets"] <= tested <= st["offsets"] + (hi - lo) // 10
