"""Deflate blocks longer than the chained decode's MAX_SPAN, through the
port's public decode on the CPU, against CPython's zlib and the JAX
package's public decode (which sends an unindexed member to its host
engine).

A coded block whose row reaches MAX_SPAN compressed bytes without its
end-of-block goes on in continuation rows (device/anyinflate.py
`plan_continuation`): each starts at the end of the last symbol that lies
wholly inside the row before (inflate2._cut), with the block's decode
tables and no header.  MAX_SPAN is cut to 64 KiB here (SPAN0 to 16 KiB),
so blocks of 100-200 KB take 2-3 rows; the card runs the same code at
2 MiB (chip_smoke.py phase 14, tests/test_torch_cuda.py).

The streams are the JAX package's host writer's, which writes one block a
shard (flate_tpu.deflate.deflate_tokens, flate_tpu.block.
write_huffman_only).  Each decodes with the lane walk, and with every lane
walk reported unjoined, so that every row takes the exact serial retry.
The JAX device function `flate_tpu.jx.anyinflate.decompress_device_any`
keeps its cap; the JAX package is left as it is.  Tolerance: exact (bytes
and error class).
"""

import functools
import io
import zlib

import numpy as np
import pytest
import torch

import flate_tpu as ft
from flate_tpu import block as j_block
from flate_tpu import deflate as j_deflate
from flate_tpu.bitpack import BitSink

import flate_tpu_torch as ftt
from flate_tpu_torch import errors
from flate_tpu_torch.api import Decompressor
from flate_tpu_torch.device import anyinflate as ai
from flate_tpu_torch.device import inflate2 as i2

from chip_smoke import member, mixed_corpus, text_corpus

SPAN = 1 << 16                   # MAX_SPAN in these tests
WBITS = {"ZLIB": 15, "GZIP": 31, "RAW": -15}


@pytest.fixture(autouse=True)
def _short_rows(monkeypatch):
    """One intra-op thread (the plain walks are many tensor ops), and rows
    of at most 64 KiB."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(ai, "MAX_SPAN", SPAN)
    monkeypatch.setattr(ai, "SPAN0", 1 << 14)
    yield
    torch.set_num_threads(n)


def _host(write) -> bytes:
    sink = BitSink()
    write(sink)
    return sink.getvalue()


@functools.lru_cache(maxsize=None)
def _streams() -> dict:
    """name -> (container, stream, input): one-block members of the JAX
    host writer, and a raw stream of two long blocks with a stored block
    between them."""
    mixed, text = mixed_corpus(400_000), text_corpus(300_000)
    out = {}
    for level, container in ((1, "ZLIB"), (6, "GZIP")):
        raw = _host(lambda s: j_deflate.deflate_tokens(
            mixed, j_deflate.CompressOptions(level=level, shard_len=1 << 20),
            s))
        out[f"jax_l{level}_one_block"] = (
            container, member(container, raw, mixed), mixed)
    raw = _host(lambda s: j_block.write_huffman_only(s, text, True))
    out["huffman_zlib"] = ("ZLIB", member("ZLIB", raw, text), text)
    out["huffman_gzip"] = ("GZIP", member("GZIP", raw, text), text)
    a, b = text_corpus(200_000), mixed_corpus(3000)
    c = text_corpus(400_000)[200_000:]

    def two(s):
        j_block.write_huffman_only(s, a, False)
        j_block.write_stored(s, b, False)
        j_block.write_huffman_only(s, c, True)
    out["raw_two_long_blocks"] = ("RAW", _host(two), a + b + c)
    return out


def _jax_decompress(container: str, blob: bytes) -> bytes:
    return getattr(ft, "flate" if container == "RAW"
                   else container.lower()).decompress(blob)


def _port(container: str):
    return getattr(ftt, "flate" if container == "RAW" else container.lower())


@pytest.fixture(params=["lanes", "serial"])
def walk(request, monkeypatch):
    """'serial': every lane walk reports its lanes unjoined, so every row
    is walked again by the exact serial walk; yields the serial walks'
    call count."""
    calls = []
    if request.param == "serial":
        lane_walk, serial_walk = i2._lane_walk, i2._walk

        def unjoined(word, start, nbits, **kw):
            mask, joined = lane_walk(word, start, nbits, **kw)
            return mask, torch.zeros_like(joined)

        def counted(*args):
            calls.append(1)
            return serial_walk(*args)
        monkeypatch.setattr(i2, "_lane_walk", unjoined)
        monkeypatch.setattr(i2, "_walk", counted)
    yield request.param, calls


@pytest.mark.parametrize("name", ["jax_l1_one_block", "jax_l6_one_block",
                                  "huffman_zlib", "huffman_gzip",
                                  "raw_two_long_blocks"])
def test_long_blocks_decode_equal_zlib_and_jax(name, walk):
    container, blob, data = _streams()[name]
    assert zlib.decompress(blob, WBITS[container]) == data
    assert _jax_decompress(container, blob) == data
    i2.STATS.clear()
    assert _port(container).decompress(blob, device="cpu") == data
    mode, serial_calls = walk
    # every block takes 2 or 3 rows: 2 continuation rows at least
    assert i2.STATS["continuation_rows"] >= 2
    assert i2.STATS["chained_members"] == 1
    if mode == "serial":
        assert len(serial_calls) >= 3


@pytest.mark.parametrize("name", ["jax_l1_one_block", "huffman_zlib"])
def test_rows_span_at_most_max_span(monkeypatch, name):
    """No row of a long block spans more than MAX_SPAN bytes, and each
    continuation row starts where the row before it was cut."""
    container, blob, data = _streams()[name]
    spans, rounds = [], []
    real_round = ai._decode_round

    def recorded(body, plans, *args):
        res = real_round(body, plans, *args)
        rounds.append({k: (r["plan"].kind, r["span"], r["end_bit"],
                           r["has_eob"]) for k, r in res.items()})
        spans.extend(r["span"] for r in res.values())
        return res
    monkeypatch.setattr(ai, "_decode_round", recorded)
    assert _port(container).decompress(blob, device="cpu") == data
    assert max(spans) == SPAN
    conts = [k for rnd in rounds for k in rnd if isinstance(k, tuple)]
    assert len(conts) >= 2
    ends = {r[2] for rnd in rounds for r in rnd.values() if not r[3]}
    assert all(bit in ends for bit, _ in conts)


def test_many_rows_do_not_stall(monkeypatch):
    """A block of more continuation rows than the stall guard's 12 rounds
    (8 KiB rows): progress is counted in rows, not in blocks."""
    monkeypatch.setattr(ai, "MAX_SPAN", 8192)
    monkeypatch.setattr(ai, "SPAN0", 8192)
    container, blob, data = _streams()["huffman_zlib"]
    i2.STATS.clear()
    assert ftt.zlib.decompress(blob, device="cpu") == data
    assert i2.STATS["continuation_rows"] >= len(blob) // 8192
    assert i2.STATS["chained_rounds"] > 12


def test_long_blocks_meet_resolve_rows(monkeypatch, walk):
    """MAX_S cut to 64 KiB as well: the continuation rows' output is cut
    again into resolve rows of at most 64 KiB, whose matches and whose
    end-of-block words meet the rows' own."""
    monkeypatch.setattr(ai, "MAX_S", 1 << 16)
    for name in ("huffman_zlib", "jax_l1_one_block"):
        container, blob, data = _streams()[name]
        i2.STATS.clear()
        assert _port(container).decompress(blob, device="cpu") == data
        assert i2.STATS["continuation_rows"] >= 2
        # two rows' output at least is cut in two (block_pieces counts the
        # pieces of rows that are cut)
        assert i2.STATS["block_pieces"] >= 4


def _cut_and_flipped() -> dict:
    """The Huffman zlib stream cut inside its second row, and with a byte
    of its third row flipped."""
    _, blob, _ = _streams()["huffman_zlib"]
    flipped = bytearray(blob)
    flipped[2 + 2 * SPAN + 3000] ^= 0x5A
    return {"cut_in_row_2": blob[:2 + SPAN + 20000],
            "flip_in_row_3": bytes(flipped)}


@pytest.mark.parametrize("case", ["cut_in_row_2", "flip_in_row_3"])
def test_broken_long_block_raises_as_jax(case, walk):
    bad = _cut_and_flipped()[case]
    with pytest.raises(ft.errors.FlateError) as want:
        ft.zlib.decompress(bad)
    with pytest.raises(errors.FlateError) as got:
        ftt.zlib.decompress(bad, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    if case == "cut_in_row_2":
        assert isinstance(got.value, errors.EndOfStream)


def _rev(v: int, n: int) -> int:
    return int(format(v, f"0{n}b")[::-1], 2)


def test_invalid_code_in_a_continuation_row():
    """A fixed block of 150,000 literals with the invalid length code 286
    at literal 100,000: the block's second row, a continuation row, stops
    at the code, which lies wholly inside it, and the decode raises the
    JAX public decode's class (not the resolve's InvalidMatch for a bad
    symbol, nor a garbage end-of-block after it), with no third row."""
    text = text_corpus(150_000)
    lits = np.frombuffer(text, np.uint8).astype(np.int64)
    codes = np.where(lits < 144, 0x30 + lits, 0x190 + lits - 144)
    widths = np.where(lits < 144, 8, 9)
    codes = np.array([_rev(int(c), int(w)) for c, w in zip(codes, widths)])
    codes[100_000], widths[100_000] = _rev(0xC6, 8), 8     # symbol 286
    values = np.concatenate([[1, 1], codes, [0]]).astype(np.uint64)
    nbits = np.concatenate([[1, 2], widths, [7]]).astype(np.int64)
    sink = BitSink()
    sink.append_fields(values, nbits)
    raw = sink.getvalue()
    with pytest.raises(ft.errors.FlateError) as want:
        ft.flate.decompress(raw)
    i2.STATS.clear()
    with pytest.raises(errors.FlateError) as got:
        ftt.flate.decompress(raw, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__ \
        == "InvalidCode"
    assert i2.STATS["continuation_rows"] == 1


WINDOW, FETCH, TRIM = 1 << 15, 1 << 14, 1 << 16


@pytest.fixture
def small_window(monkeypatch):
    """Decompressor windows of 32 KiB, less than every long block."""
    monkeypatch.setattr(Decompressor, "WINDOW", WINDOW)
    monkeypatch.setattr(Decompressor, "FETCH", FETCH)
    monkeypatch.setattr(Decompressor, "TRIM", TRIM)


def _served(d, n: int = 50_000):
    """What d.read(n) serves until the end or an error: (bytes, the
    error's class name or None)."""
    got = bytearray()
    try:
        while chunk := d.read(n):
            got += chunk
    except (ft.errors.FlateError, errors.FlateError) as e:
        return bytes(got), type(e).__name__
    return bytes(got), None


def _jax_decompressor(container: str, blob: bytes):
    return getattr(ft, "flate" if container == "RAW"
                   else container.lower()).decompressor(io.BytesIO(blob))


@pytest.mark.parametrize("name", ["jax_l1_one_block", "jax_l6_one_block",
                                  "huffman_zlib", "huffman_gzip",
                                  "raw_two_long_blocks"])
def test_decompressor_window_smaller_than_the_block(small_window, name):
    """The streaming decompressor at a 32 KiB window, less than each long
    block: a step decodes the block up to the window's end and hands it on,
    the next step goes on inside it, so the window never grows and input
    memory stays at TRIM + WINDOW + FETCH."""
    container, blob, data = _streams()[name]
    i2.STATS.clear()
    d = _port(container).decompressor(io.BytesIO(blob), device="cpu")
    got, err = _served(d)
    assert err is None and got == data and d.at_end()
    assert d.stats["input_peak"] <= TRIM + WINDOW + FETCH
    assert d.stats["steps"] >= len(blob) // WINDOW
    assert i2.STATS["continuation_rows"] >= 2
    assert _served(_jax_decompressor(container, blob)) == (data, None)


def _broken_streams() -> dict:
    """The Huffman zlib stream (one 164,292-byte block) with one bit
    flipped in its second and in its last 32 KiB window, and cut inside
    its third."""
    _, blob, _ = _streams()["huffman_zlib"]
    out = {}
    for name, at in (("flip_in_window_2", 2 + WINDOW + WINDOW // 2),
                     ("flip_in_last_window", len(blob) - 3000)):
        b = bytearray(blob)
        b[at] ^= 0x08
        out[name] = (bytes(b), at)
    out["cut_in_window_3"] = (blob[:2 + 2 * WINDOW + 5000], None)
    return out


@pytest.mark.parametrize("case", ["flip_in_window_2", "flip_in_last_window",
                                  "cut_in_window_3"])
def test_broken_long_block_streams_as_jax(small_window, case):
    """A broken long block read at a window smaller than it: the verdict of
    the JAX Decompressor and of ft.zlib.decompress, and the JAX
    Decompressor's bytes served before it.  A cut stream raises
    EndOfStream having served a prefix of the input.  A flipped bit in a
    Huffman-only block decodes on (the code resynchronises) to the
    checksum's verdict: the bytes served before it equal the input up to
    the output of the bits before the flipped byte, as the JAX
    Decompressor's do."""
    _, _, data = _streams()["huffman_zlib"]
    bad, at = _broken_streams()[case]
    with pytest.raises(ft.errors.FlateError) as want:
        ft.zlib.decompress(bad)
    jgot, jerr = _served(_jax_decompressor("ZLIB", bad))
    got, err = _served(ftt.zlib.decompressor(io.BytesIO(bad), device="cpu"))
    assert err == jerr == type(want.value).__name__
    if at is None:
        assert err == "EndOfStream"
        assert data.startswith(got) and data.startswith(jgot)
    else:
        before = len(zlib.decompressobj().decompress(bad[:at]))
        assert got == jgot and got[:before] == data[:before]


def _fixed_too_far_then_bad(n: int = 150_000, bad_at: int = 100_000):
    """A raw fixed block: the literal "a", a match of length 3 at distance
    2 (before the start of the stream), `n` literals of text with the
    invalid length code 286 in place of literal `bad_at`, and the
    end-of-block: a match too far back in its first 32 KiB window and an
    invalid code in its fourth."""
    lits = np.frombuffer(text_corpus(n), np.uint8).astype(np.int64)
    codes = np.where(lits < 144, 0x30 + lits, 0x190 + lits - 144)
    widths = np.where(lits < 144, 8, 9)
    codes = np.array([_rev(int(c), int(w)) for c, w in zip(codes, widths)])
    codes[bad_at], widths[bad_at] = _rev(0xC6, 8), 8     # symbol 286
    values = np.concatenate([[1, 1, _rev(0x91, 8), _rev(1, 7), _rev(1, 5)],
                             codes, [0]]).astype(np.uint64)
    nbits = np.concatenate([[1, 2, 8, 7, 5], widths, [7]]).astype(np.int64)
    sink = BitSink()
    sink.append_fields(values, nbits)
    return sink.getvalue()


def test_too_far_then_invalid_code_across_windows(small_window):
    """A match that reaches before the stream's start in the first window
    of a long block, an invalid code in a later one: InvalidMatch, the
    first error in stream order, one-shot and streamed, as the JAX
    package's public decode and Decompressor give it; nothing is served
    before it."""
    raw = _fixed_too_far_then_bad()
    with pytest.raises(ft.errors.FlateError) as want:
        ft.flate.decompress(raw)
    jgot, jerr = _served(_jax_decompressor("RAW", raw))
    with pytest.raises(errors.FlateError) as one:
        ftt.flate.decompress(raw, device="cpu")
    got, err = _served(ftt.flate.decompressor(io.BytesIO(raw),
                                              device="cpu"))
    assert err == jerr == type(want.value).__name__ \
        == type(one.value).__name__ == "InvalidMatch"
    assert got == b""


def test_cut_stops_at_whole_symbols():
    """inflate2._cut on synthetic chains: literals of 9 bits, then a
    symbol that runs past the row's bits; an invalid code; an end-of-block
    word, which a row without one never counts; lanes unjoined after the
    cut do not matter, an unjoined lane before it does."""
    lit = 0x41 << 8 | i2.K_LIT << 6 | 9
    bad = i2.K_BAD << 6 | 1
    eob = i2.K_EOB << 6 | 7
    words = torch.tensor([[lit] * 10 + [0] * 6,
                          [lit] * 3 + [bad] + [lit] * 12,
                          [lit] * 2 + [eob] + [lit] * 13,
                          [lit] * 16], dtype=torch.int32)
    n = torch.tensor([10, 16, 16, 16], dtype=torch.int32)
    start = torch.tensor([5, 0, 0, 0], dtype=torch.int32)
    nbits = torch.tensor([90, 256, 256, 100], dtype=torch.int32)
    joined = torch.ones((4, 8), dtype=torch.bool)
    joined[0, 3] = False                     # after row 0's cut (lane 2)
    joined[3, 0] = False                     # row 3's start lane
    counts, out_len, end_bit, unproven = i2._cut(words, n, start, nbits,
                                                 joined, G=32)
    assert counts.tolist() == [9, 3, 2, 11]
    assert end_bit.tolist() == [86, 27, 18, 99]
    assert out_len.tolist() == [9, 3, 2, 11]
    assert unproven.tolist() == [False, False, False, True]
    serial = i2._cut(words, n, start, nbits)
    assert [t.tolist() for t in serial[:3]] == \
        [counts.tolist(), out_len.tolist(), end_bit.tolist()]
    assert not serial[3].any()
