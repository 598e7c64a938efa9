"""The port's streaming Decompressor holds at most OUT_CAP bytes of decoded
output that it has not served, plus the bytes the current read asks for,
whatever the member's size and ratio, as the JAX package's Decompressor
(its native resumable stream) holds O(64 KiB): against the JAX
Decompressor's bytes and the port's one-shot decode.

A step decodes its window's chain and leaves the symbols unresolved; the
reads resolve them a batch of at most OUT_CAP bytes at a time
(anyinflate.Resolve), so `stats["output_peak"]` stays at most OUT_CAP + n
for reads of n bytes.  The zeros stream is the case a high ratio makes:
16 KB of input, 16 MiB of output, one window.  The other streams run at
an OUT_CAP of a few KiB (and a MAX_S below it) so that one step's chain
resolves in many batches.  Tolerance: exact (bytes and error class).
"""

import io
import zlib

import numpy as np
import pytest
import torch

import flate_tpu as ft
from flate_tpu.api import Decompressor as JDecompressor
from flate_tpu.containers import Container as JContainer

import flate_tpu_torch as ftt
from flate_tpu_torch import api
from flate_tpu_torch.api import Decompressor
from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import anyinflate as ai

from _torch_corpora import corpus, small_blocks

ZEROS = zlib.compress(b"\0" * (16 << 20), 6)
SMALL = dict(device="cpu", shard_len=4096, ctx=1024, batch=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain walks are many tiny tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ChunkReader(io.RawIOBase):
    """A pipe-like reader: at most `max_chunk` bytes a read."""

    def __init__(self, data: bytes, max_chunk: int):
        self._data, self._pos, self._max = data, 0, max_chunk

    def read(self, n: int = -1) -> bytes:
        n = self._max if n < 0 or n > self._max else n
        chunk = self._data[self._pos:self._pos + n]
        self._pos += len(chunk)
        return chunk


class Recorded(Decompressor):
    """The port's Decompressor, each instance kept for its stats."""
    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        Recorded.made.append(self)


def test_constants():
    """OUT_CAP is one resolve row of MAX_S bytes, and more than a match."""
    assert Decompressor.OUT_CAP == ai.MAX_S == 4 << 20
    assert Decompressor.CHUNK == 1 << 16
    with pytest.raises(ValueError):
        ai.Resolve([], b"", b"", torch.device("cpu"), out_cap=258)


def test_zeros_reader_to_writer(monkeypatch):
    """16 MiB of zeros (zlib level 6, 16,316 bytes) through
    zlib.decompress(reader, writer=): the JAX package's bytes, with at
    most OUT_CAP + CHUNK bytes of output held (the whole 16 MiB before)."""
    monkeypatch.setattr(api, "Decompressor", Recorded)
    Recorded.made.clear()
    out = io.BytesIO()
    assert ftt.zlib.decompress(ChunkReader(ZEROS, 1 << 17), writer=out,
                               device="cpu") is None
    want = io.BytesIO()
    ft.zlib.decompress(ChunkReader(ZEROS, 1 << 17), writer=want)
    assert out.getvalue() == want.getvalue() == b"\0" * (16 << 20)
    (d,) = Recorded.made
    assert 0 < d.stats["output_peak"] <= Decompressor.OUT_CAP + \
        Decompressor.CHUNK
    assert d.stats["input_peak"] == len(ZEROS)


def test_zeros_first_read():
    """A first read(65536) of the zeros member resolves one batch, not
    the member: output_peak <= OUT_CAP + 65,536."""
    d = ftt.zlib.decompressor(io.BytesIO(ZEROS), device="cpu")
    assert d.read(65536) == bytes(65536)
    assert d.stats["steps"] == 1
    assert 65536 <= d.stats["output_peak"] <= Decompressor.OUT_CAP + 65536


# ---------------------------------------------------------------------------
# small caps: many batches a step
# ---------------------------------------------------------------------------

def _huffman_only(data: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_HUFFMAN_ONLY)
    return c.compress(data) + c.flush()


def _stored_heavy(data: bytes) -> bytes:
    """A zlib member of 5,000-byte pieces, coded (level 6) and stored
    (level 0) by turns: each piece a raw stream of its own, synced to a
    byte and not final, then an empty final stored block."""
    raw = []
    for i in range(0, len(data), 5000):
        c = zlib.compressobj(0 if i // 5000 % 2 else 6, zlib.DEFLATED, -15)
        raw.append(c.compress(data[i:i + 5000]) + c.flush(zlib.Z_SYNC_FLUSH))
    raw.append(zlib.compressobj(0, zlib.DEFLATED, -15).flush())
    return b"\x78\x01" + b"".join(raw) + \
        zlib.adler32(data).to_bytes(4, "big")


def _gzip_member(data: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, 31, 2)
    return c.compress(data) + c.flush()


def _streams() -> dict:
    """name -> (container, stream, members' outputs)."""
    text = corpus("text", 24_000, seed=71)
    mixed = corpus("mixed", 24_000, seed=72)
    rnd = corpus("random", 12_000, seed=73)
    alt = b"".join(text[i:i + 5000] + rnd[i // 2:i // 2 + 5000]
                   for i in range(0, 10_000, 5000))
    a, b = text[:9000], mixed[:11_000]
    return {
        "text_l1": ("ZLIB", small_blocks(text, level=1), [text]),
        "huffman_one_block": ("ZLIB", _huffman_only(text), [text]),
        "stored_heavy": ("ZLIB", _stored_heavy(alt), [alt]),
        "flt1_member": ("GZIP", ftt.gzip.compress(mixed, 1, **SMALL),
                        [mixed]),
        "two_members": ("GZIP", ftt.gzip.compress(a, 6, **SMALL)
                        + _gzip_member(b), [a, b]),
    }


STREAMS = _streams()


def _members(d, n: int) -> list:
    """Every member of the stream, read `n` bytes at a time, reset()
    between members."""
    outs = []
    while True:
        got = bytearray()
        while chunk := d.read(n):
            got += chunk
        outs.append(bytes(got))
        if d.at_end():
            return outs
        d.reset()


@pytest.mark.parametrize("max_s", [None, 1024])
@pytest.mark.parametrize("n", [1, 17, 65536, -1])
@pytest.mark.parametrize("name", list(STREAMS))
def test_small_out_cap(monkeypatch, name, n, max_s):
    """OUT_CAP cut to 4 KiB (and MAX_S to 1 KiB, below it), windows of 8
    KiB: the output of every read equals the one-shot decode's and the
    JAX Decompressor's, and no more than OUT_CAP + n bytes are held."""
    monkeypatch.setattr(Decompressor, "OUT_CAP", 4096)
    monkeypatch.setattr(Decompressor, "WINDOW", 8192)
    monkeypatch.setattr(Decompressor, "FETCH", 3000)
    monkeypatch.setattr(Decompressor, "TRIM", 16384)
    if max_s is not None:
        monkeypatch.setattr(ai, "MAX_S", max_s)
    container, blob, want = STREAMS[name]
    d = Decompressor(ChunkReader(blob, 5000), Container[container],
                     device="cpu")
    got = _members(d, n)
    assert got == want
    ns = getattr(ftt, container.lower())
    assert ns.decompress(blob, device="cpu") == b"".join(want)
    assert _members(JDecompressor(blob, JContainer[container]), n) == want
    if n > 0:
        assert d.stats["output_peak"] <= 4096 + n
    assert d.stats["input_peak"] <= 16384 + 8192 + 3000


def _too_far_late() -> tuple:
    """A raw stream, made with a 32 KiB preset dictionary of bytes above
    127, of 20,000 bytes of text (no match can reach the dictionary) and
    2,000 bytes copied from the dictionary's last 8,000: decoded without
    it, the copy's matches reach before the stream's start, 20,000 bytes
    in."""
    zd = np.random.default_rng(74).integers(128, 256, 32768,
                                            dtype=np.uint8).tobytes()
    text = corpus("text", 20_000, seed=75)
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=zd)
    return c.compress(text + zd[-8000:-6000]) + c.flush(), text


def test_invalid_match_in_a_later_batch(monkeypatch):
    """The match before the history lies in a batch after the first: the
    streamed reads serve the bytes before it, then raise InvalidMatch, as
    read_all(), the one-shot decode and the JAX Decompressor do."""
    monkeypatch.setattr(Decompressor, "OUT_CAP", 4096)
    blob, text = _too_far_late()
    d = Decompressor(ChunkReader(blob, 5000), Container.RAW, device="cpu")
    got = bytearray()
    with pytest.raises(ftt.errors.InvalidMatch):
        while chunk := d.read(1000):
            got += chunk
    assert d.stats["steps"] == 1
    assert len(got) >= 4096 and text.startswith(bytes(got))
    with pytest.raises(ftt.errors.InvalidMatch):
        Decompressor(blob, Container.RAW, device="cpu").read_all()
    with pytest.raises(ftt.errors.InvalidMatch):
        ftt.flate.decompress(blob, device="cpu")
    with pytest.raises(ft.errors.InvalidMatch):
        JDecompressor(blob, JContainer.RAW).read_all()
