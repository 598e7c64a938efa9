"""Valid zlib/gzip streams whose blocks exceed the chained decode's old caps,
through the port's public decode on the CPU, against zlib and the JAX
package's public decode (which sends an unindexed member to its host
engine).

- Blocks of more than MAX_S = 4 MiB of output (zlib's blocks of 16,383 or,
  at memLevel 9, 32,767 matches of 258 bytes on zero runs) resolve in rows
  of at most MAX_S bytes cut at symbol boundaries
  (device/anyinflate.py `_pieces`).
- Blocks with more symbols than twice their compressed bytes (Huffman-only
  zeros: a 1-bit literal a byte, 32,767 a block) fit their rows: a row of
  a C-byte span has 8 C symbol slots, a slot a bit.

The JAX device function `flate_tpu.jx.anyinflate.decompress_device_any`
raises on these streams; the JAX package is left as it is.  The card tests
of the same streams are in tests/test_torch_cuda.py.  Tolerance: exact
(bytes).
"""

import zlib

import pytest
import torch

import flate_tpu as ft
from flate_tpu import errors as j_errors

import flate_tpu_torch as ftt
from flate_tpu_torch import errors
from flate_tpu_torch.device import anyinflate as ai
from flate_tpu_torch.device import inflate2 as i2

from _torch_corpora import big_block_streams, long_run_text

STREAMS = big_block_streams()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain walks and resolves are many tensor ops: one intra-op
    thread keeps parallel test workers off each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wbits(container: str) -> int:
    return 31 if container == "GZIP" else 15


@pytest.mark.parametrize("name", list(STREAMS))
def test_big_blocks_decode_equal_zlib_and_jax(name):
    container, blob = STREAMS[name]
    want = zlib.decompress(blob, _wbits(container))
    ns = getattr(ftt, container.lower())
    i2.STATS.clear()
    got = ns.decompress(blob, device="cpu")
    assert got == want
    assert getattr(ft, container.lower()).decompress(blob, device=True) \
        == want
    if name.startswith("huffman"):
        assert len(want) > 2 * len(blob)
    else:
        assert i2.STATS["block_pieces"] >= 2


@pytest.mark.parametrize("cap", [1 << 16, 1 << 18])
def test_small_resolve_rows_cut_inside_matches(monkeypatch, cap):
    """MAX_S cut to 64 KiB (and 256 KiB): blocks of text with long runs
    resolve in many rows, most cuts inside the output of long matches
    whose sources lie rows back."""
    data = long_run_text()
    blob = zlib.compress(data, 6)
    monkeypatch.setattr(ai, "MAX_S", cap)
    i2.STATS.clear()
    assert ftt.zlib.decompress(blob, device="cpu") == data
    assert i2.STATS["block_pieces"] > len(data) // cap


def test_pieces_cut_at_symbol_boundaries(monkeypatch):
    """_pieces on a block of literals and 258-byte matches: every row but
    the last ends in an end-of-block word of its own, holds at most MAX_S
    bytes, and the rows' symbols are the block's in order."""
    monkeypatch.setattr(ai, "MAX_S", 4096)
    lit = 0x41 << 8 | i2.K_LIT << 6 | 8
    match = 255 << 8 | i2.K_MATCH << 6 | 1
    eob = i2.K_EOB << 6 | 7
    words = torch.tensor([lit] * 5 + [match] * 40 + [lit] * 3 + [eob],
                         dtype=torch.int32)
    out_len = 8 + 40 * 258
    rows = ai._pieces(words, out_len)
    assert len(rows) == 3
    assert sum(ol for _, _, ol in rows) == out_len
    joined = []
    for w, c, ol in rows:
        assert w.shape[0] == c and ol <= ai.MAX_S
        assert int(w[-1]) >> 6 & 3 == i2.K_EOB
        kind = (w[:-1] >> 6) & 3
        assert int(torch.where(kind == i2.K_MATCH, 258, 1).sum()) == ol
        joined += w[:-1].tolist()
    assert joined == words[:-1].tolist()
    assert rows[-1][0][-1] == eob
    assert ai._pieces(words, 4096)[0][0] is words


@pytest.mark.parametrize("serial", [False, True])
def test_rows_hold_a_symbol_a_bit(serial):
    """The first block of Huffman-only zeros (32,767 1-bit literals and the
    end-of-block in its first 8 KiB span) decodes in one round, by the
    lane walk and by the serial walk: its row's slots are the span's
    bits, not twice its bytes."""
    body = STREAMS["huffman_40000"][1][2:]
    plan = ai.plan_block_at(body, 0)
    res = ai._decode_round(body, [plan], {}, {0} if serial else set(),
                           torch.device("cpu"))[0]
    assert res["ok"] and res["has_eob"] and res["serial"] == serial
    assert res["counts"] == 32768 > 2 * res["span"]
    assert res["out_len"] == 32767


def _corruptions(blob: bytes) -> dict:
    """The stream with its Adler-32 flipped, and with the first bit flip
    past its middle that zlib rejects.  (A stream cut short raises
    InvalidCode on the chained route, as the JAX device function does,
    where the JAX public decode raises EndOfStream: ROADMAP C.)"""
    out = {}
    bad = bytearray(blob)
    bad[-1] ^= 1
    out["adler"] = bytes(bad)
    for i in range(len(blob) // 2, len(blob) - 4):
        bad = bytearray(blob)
        bad[i] ^= 0x08
        try:
            zlib.decompress(bytes(bad))
        except zlib.error:
            out["flip"] = bytes(bad)
            break
    return out


@pytest.mark.parametrize("kind", ["adler", "flip"])
def test_corrupt_big_block_raises_as_jax(kind):
    """A corrupt stream with a 4 MiB+ block still raises the JAX public
    decode's error class."""
    bad = _corruptions(STREAMS["text_5mib_run"][1])[kind]
    with pytest.raises(j_errors.FlateError) as want:
        ft.zlib.decompress(bad, device=True)
    with pytest.raises(errors.FlateError) as got:
        ftt.zlib.decompress(bad, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
