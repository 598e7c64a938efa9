"""The port's streaming Decompressor on the CPU, against the JAX package's
Decompressor (its native resumable stream) and CPython's zlib: the cases of
tests/test_streaming_decode.py and tests/test_streaming_io.py.

The decode windows are shrunk to a few KiB (Decompressor.WINDOW, FETCH,
TRIM), so one stream takes many steps and blocks straddle the windows'
ends; zlib's streams at a low memLevel keep its blocks a few hundred bytes
long.  Tolerance: exact (bytes and error class).
"""

import io
import zlib

import pytest
import torch

import flate_tpu as ft
from flate_tpu.api import Decompressor as JDecompressor
from flate_tpu.containers import Container as JContainer

import flate_tpu_torch as ftt
from flate_tpu_torch import inflate as hinf
from flate_tpu_torch.api import Decompressor
from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import anyinflate as ai
from flate_tpu_torch.device import inflate2 as i2

from _torch_corpora import corpus, small_blocks

WINDOW, FETCH, TRIM = 8192, 3000, 16384
SMALL = dict(device="cpu", shard_len=4096, ctx=1024, batch=2)
DATA = corpus("mixed", 60_000, seed=21)
ZBLOB = small_blocks(DATA)


@pytest.fixture(autouse=True, scope="module")
def _small_windows():
    """One intra-op thread (the plain walks are many tiny tensor ops), and
    decode windows of a few KiB."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = Decompressor.WINDOW, Decompressor.FETCH, Decompressor.TRIM
    Decompressor.WINDOW, Decompressor.FETCH, Decompressor.TRIM = \
        WINDOW, FETCH, TRIM
    yield
    Decompressor.WINDOW, Decompressor.FETCH, Decompressor.TRIM = saved
    torch.set_num_threads(n)


class ChunkReader(io.RawIOBase):
    """Serves at most `max_chunk` bytes a read and counts the reads."""

    def __init__(self, data: bytes, max_chunk: int):
        self._data, self._pos, self._max, self.calls = data, 0, max_chunk, 0

    def read(self, n: int = -1) -> bytes:
        self.calls += 1
        n = self._max if n < 0 or n > self._max else n
        chunk = self._data[self._pos:self._pos + n]
        self._pos += len(chunk)
        return chunk


def _drain(d, n: int) -> bytes:
    got = bytearray()
    while chunk := d.read(n):
        got += chunk
    return bytes(got)


def _outcome(fn):
    try:
        return fn()
    except (ft.errors.FlateError, ftt.errors.FlateError) as e:
        return type(e).__name__


@pytest.mark.parametrize("n", [977, 7777, 50_000, -1])
def test_chunked_reads_match_oneshot(n):
    d = Decompressor(ZBLOB, Container.ZLIB, device="cpu")
    assert _drain(d, n) == DATA
    assert d.at_end()
    assert d.stats["steps"] >= len(ZBLOB) // WINDOW
    assert _drain(JDecompressor(ZBLOB, JContainer.ZLIB), n) == DATA


def test_single_byte_reads():
    data = DATA[:6000]
    d = Decompressor(io.BytesIO(small_blocks(data, 15)), Container.ZLIB,
                     device="cpu")
    assert _drain(d, 1) == data
    assert d.read(1) == b""


def test_input_memory_is_bounded():
    """Steps hold at most TRIM bytes of consumed input, a window and a
    fetch: far less than the stream."""
    data = corpus("random", 120_000, seed=22)
    blob = small_blocks(data, mem_level=1, level=1)
    d = Decompressor(ChunkReader(blob, 1 << 20), Container.ZLIB,
                     device="cpu")
    assert _drain(d, 30_000) == data
    assert d.stats["input_peak"] <= TRIM + WINDOW + FETCH < len(blob)


def test_window_grows_for_a_block_that_does_not_fit():
    """Stored blocks of 16 KiB do not fit an 8 KiB window, and the window
    does not grow for them: a step emits the payload up to the window's
    end and the next step copies the rest, so input memory stays at TRIM
    + WINDOW + FETCH."""
    data = corpus("random", 40_000, seed=23)
    c = zlib.compressobj(0, zlib.DEFLATED, 15)
    blob = b"".join(c.compress(data[i:i + 16384]) + c.flush(zlib.Z_FULL_FLUSH)
                    for i in range(0, len(data), 16384)) + c.flush()
    d = Decompressor(ChunkReader(blob, 1 << 20), Container.ZLIB,
                     device="cpu")
    assert _drain(d, 5000) == data
    assert d.stats["input_peak"] <= TRIM + WINDOW + FETCH
    assert d.stats["steps"] >= len(blob) // WINDOW
    assert _drain(JDecompressor(blob, JContainer.ZLIB), 5000) == data


def _block_headers(raw: bytes) -> list:
    """(header bit, kind) of every block of a raw deflate stream, walked
    by the port's host decode."""
    out, bit, got = [], 0, bytearray()
    while True:
        p = ai.plan_block_at(raw, bit)
        out.append((bit, p.kind))
        if p.kind == "stored":
            bit = p.end_bit
        else:
            cur = hinf._BitCursor(raw, p.body_bit)
            if p.lens is None:
                ll, d = hinf.fixed_tables()
            else:
                ll = hinf.build_decode_table(p.lens[0], 15, True)
                d = hinf.build_decode_table(p.lens[1], 15, False)
            hinf._decode_coded_block(cur, got, ll, d)
            bit = cur.pos
        if p.bfinal:
            return out


@pytest.mark.parametrize("cut", [3, 40, 150])
def test_block_header_straddles_the_window(cut):
    """A dynamic block's header that runs `cut` bits past a window's end:
    the step stops at the header (no carry), and the next step parses it
    whole; through the Decompressor too, at that window."""
    data = corpus("text", 30_000, seed=28)
    raw = small_blocks(data, -15)
    heads = [b for b, kind in _block_headers(raw)[1:] if kind == "coded"]
    h = heads[len(heads) // 2]
    assert ai.plan_block_at(raw, h).lens is not None    # dynamic
    end = (h + cut + 7) >> 3
    kw = dict(chunk_bytes=512, device="cpu")
    res, stop, done, carry = ai.decode_step(raw[:end], 0, b"",
                                            final_input=False, **kw)
    out = b"".join(res)
    assert (stop, done, carry) == (h, False, None)
    assert data.startswith(out)
    rest, _, done, _ = ai.decode_step(raw[h >> 3:], h & 7, res.hist,
                                      final_input=True, **kw)
    assert out + b"".join(rest) == data and done
    d = Decompressor(ChunkReader(raw, 1 << 20), Container.RAW,
                     device="cpu")
    d.WINDOW = end
    assert _drain(d, 4000) == data
    assert d.stats["input_peak"] <= TRIM + d.WINDOW + FETCH


def test_flt1_member_at_a_window_smaller_than_its_blocks():
    """The port's gzip member at shard_len 4096 (a block a shard, stored
    where the mixed corpus is random) read at a 1 KiB window: the blocks
    run past the windows and are carried, the chains start at the FLT1
    shard offsets with no false head."""
    data = corpus("mixed", 40_000, seed=29)
    blob = ftt.gzip.compress(data, 1, **SMALL)
    i2.STATS.clear()
    d = Decompressor(ChunkReader(blob, 1 << 20), Container.GZIP,
                     device="cpu")
    d.WINDOW, d.FETCH, d.TRIM = 1024, 512, 2048
    assert _drain(d, 3000) == data
    assert d.stats["input_peak"] <= 2048 + 1024 + 512
    assert d.stats["steps"] >= len(blob) // 1024
    assert i2.STATS["false_heads"] == 0
    assert i2.STATS["continuation_rows"] >= 1
    assert _drain(JDecompressor(blob, JContainer.GZIP), 3000) == data


def test_mid_member_set_reader():
    cut = len(ZBLOB) // 2
    d = Decompressor(ZBLOB[:cut], Container.ZLIB, device="cpu")
    first = d.read(20_000)
    assert first == DATA[:20_000]
    d.set_reader(ZBLOB[cut:])
    assert first + d.read(-1) == DATA


def test_mid_member_set_reader_file():
    cut = len(ZBLOB) // 3
    d = Decompressor(io.BytesIO(ZBLOB[:cut]), Container.ZLIB, device="cpu")
    first = d.read(10_000)
    d.set_reader(io.BytesIO(ZBLOB[cut:]))
    assert first + d.read(-1) == DATA


def test_concatenated_members_reset():
    a, b = b"first member " * 1000, b"second member " * 1000
    blob = zlib.compress(a, 6) + zlib.compress(b, 9)
    d = Decompressor(blob, Container.ZLIB, device="cpu")
    assert d.read(-1) == a
    assert not d.at_end()
    d.reset()
    assert d.read(-1) == b
    assert d.at_end()


def test_wrong_checksum_detected_at_member_end():
    blob = bytearray(ZBLOB)
    blob[-2] ^= 0xFF                      # corrupt the Adler-32 footer
    for cls, cont in ((Decompressor, Container.ZLIB),
                      (JDecompressor, JContainer.ZLIB)):
        kw = {"device": "cpu"} if cls is Decompressor else {}
        d = cls(bytes(blob), cont, **kw)
        got = bytearray()
        with pytest.raises((ftt.errors.WrongZlibChecksum,
                            ft.errors.WrongZlibChecksum)):
            while chunk := d.read(30_000):
                got += chunk
        # every payload byte was served before the footer check fired
        assert bytes(got) == DATA


def test_verify_false_skips_the_checksum():
    blob = bytearray(ZBLOB)
    blob[-1] ^= 0xFF
    d = Decompressor(bytes(blob), Container.ZLIB, verify=False, device="cpu")
    assert d.read(-1) == DATA
    assert ftt.zlib.decompress(bytes(blob), verify=False, device="cpu") \
        == ft.zlib.decompress(bytes(blob), verify=False) == DATA


def test_own_gzip_member_chains_from_its_index():
    """The port's gzip member carries the FLT1 index: each step's chains
    start at its shard offsets, one a shard."""
    data = corpus("text", 40_000, seed=24)
    blob = ftt.gzip.compress(data, 1, **SMALL)
    i2.STATS.clear()
    d = Decompressor(blob, Container.GZIP, device="cpu")
    assert _drain(d, 7777) == data
    assert d.stats["steps"] >= 2
    assert i2.STATS["chain_heads"] >= len(data) // 4096


def test_dictionary_member():
    d_ = corpus("text", 5000, seed=25)
    data = corpus("text", 30_000, seed=26)
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 2, zdict=d_)
    blob = c.compress(data) + c.flush()
    d = Decompressor(ChunkReader(blob, 999), Container.ZLIB, dictionary=d_,
                     device="cpu")
    assert _drain(d, 4096) == data
    with pytest.raises(ftt.errors.BadZlibHeader):
        Decompressor(blob, Container.ZLIB, device="cpu").read(1)


# ---------------------------------------------------------------------------
# reader -> writer through the namespaces (tests/test_streaming_io.py)
# ---------------------------------------------------------------------------

def test_decompress_from_reader_streams():
    gz = ftt.gzip.compress(DATA, 3, **SMALL)
    r = ChunkReader(gz, 1 << 12)
    out = io.BytesIO()
    assert ftt.gzip.decompress(r, out, device="cpu") is None
    assert out.getvalue() == DATA
    assert r.calls > 2


def test_decompress_reader_tiny_chunks():
    data = DATA[:20_000]
    d = ftt.zlib.decompressor(ChunkReader(small_blocks(data), 97),
                              device="cpu")
    assert _drain(d, 1000) == data


def test_decompress_reader_concat_members():
    a, b = DATA[:25_000], DATA[25_000:]
    gz = ftt.gzip.compress(a, 1, **SMALL) + small_blocks(b, 31)
    out = io.BytesIO()
    ftt.gzip.decompress(ChunkReader(gz, 313), out, device="cpu")
    assert out.getvalue() == a + b


@pytest.mark.parametrize("cut", [-9, -4, 1 / 2, 1 / 7, 11])
def test_decompress_reader_truncated_raises(cut):
    gz = small_blocks(DATA[:30_000], 31)
    end = cut if isinstance(cut, int) else int(len(gz) * cut)
    blob = gz[:end]
    r = ChunkReader(blob, 1 << 12)
    with pytest.raises(ftt.errors.EndOfStream):
        ftt.gzip.decompress(r, io.BytesIO(), device="cpu")
    want = _outcome(lambda: ft.gzip.decompress(ChunkReader(blob, 1 << 12),
                                               writer=io.BytesIO()))
    assert want == "EndOfStream"


@pytest.mark.parametrize("ns", ["zlib", "flate"])
def test_decompress_reader_zlib_and_raw(ns):
    blob = small_blocks(DATA, 15 if ns == "zlib" else -15)
    out = io.BytesIO()
    getattr(ftt, ns).decompress(ChunkReader(blob, 509), out, device="cpu")
    assert out.getvalue() == DATA


def test_corrupt_stream_raises_as_jax():
    """A bit flipped in the body: the reader path raises the class the
    JAX package's streaming decode raises."""
    blob = bytearray(small_blocks(DATA[:20_000], 15))
    blob[len(blob) // 2] ^= 0x10
    got = _outcome(lambda: ftt.zlib.decompress(ChunkReader(bytes(blob), 777),
                                               io.BytesIO(), device="cpu"))
    want = _outcome(lambda: ft.zlib.decompress(ChunkReader(bytes(blob), 777),
                                               writer=io.BytesIO()))
    assert got == want


def test_step_resumes_at_byte_boundaries():
    """decode_step over the stream cut at byte k decodes a prefix of the
    output and stops at a block boundary or inside the block the cut
    falls in; the next step from there, with the history and the carry it
    returned, decodes the rest.  Cuts every 67 bytes."""
    data = corpus("mixed", 6000, seed=27)
    raw = small_blocks(data, -15)
    kw = dict(chunk_bytes=512, device="cpu")
    for k in range(1, len(raw) + 1, 67):
        res, stop, done, carry = ai.decode_step(
            raw[:k], 0, b"", final_input=False, **kw)
        out = b"".join(res)
        assert data.startswith(out) and not done
        rest, _, done, _ = ai.decode_step(
            raw[stop >> 3:], stop & 7, res.hist, final_input=True,
            carry=carry, **kw)
        assert out + b"".join(rest) == data and done
