"""Preset dictionaries and the exact history bound of the resolve, on the
CPU, against the JAX package's public decode and CPython's zlib.

The cases of tests/test_dictionary.py (raw and zlib FDICT members, zlib's
own dictionary stream), the port's own FDICT member, a dictionary over
32 KiB, and matches that reach before the real history: before the
dictionary, or before the start of a stream without one (the two streams of
chip_smoke.py `too_far_streams`).  A match may reach only as far back as
the bytes of real history, `hist_len`, which `_resolve` (indexed route)
and `resolve_compact` (chained route) test directly.  Tolerance: exact
(bytes and error class).
"""

import io
import zlib as pyzlib

import numpy as np
import pytest
import torch

import flate_tpu as ft

import flate_tpu_torch as ftt
from flate_tpu_torch.device import anyinflate as ai
from flate_tpu_torch.device import inflate2 as i2

from _torch_corpora import corpus, too_far_streams

DICT = b"the quick brown fox jumps over the lazy dog " * 20
DATA = b"the quick brown fox says hello to the lazy dog and jumps away"
SMALL = dict(device="cpu", shard_len=4096, ctx=1024, batch=2)
CTX = ai.CTX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw_with(data: bytes, zdict: bytes, level: int = 6) -> bytes:
    c = pyzlib.compressobj(level, pyzlib.DEFLATED, -15, zdict=zdict)
    return c.compress(data) + c.flush()


def test_raw_dictionary_stream_of_jax():
    blob = ft.flate.compress(DATA, level=6, dictionary=DICT)
    assert ftt.flate.decompress(blob, dictionary=DICT, device="cpu") == DATA
    assert ftt.flate.decompress(_raw_with(DATA, DICT), dictionary=DICT,
                                device="cpu") == DATA


def test_zlib_fdict_member_of_jax():
    blob = ft.zlib.compress(DATA, level=6, dictionary=DICT)
    assert blob[1] & 0x20
    assert ftt.zlib.decompress(blob, dictionary=DICT, device="cpu") == DATA


@pytest.mark.parametrize("name", ["flate", "zlib"])
def test_own_dictionary_member(name):
    """The port's own member with a preset dictionary reads back, as the
    JAX package and zlib read it."""
    data = corpus("text", 12000, seed=7)
    d = corpus("text", 5000, seed=8)
    blob = getattr(ftt, name).compress(data, 1, dictionary=d, **SMALL)
    assert getattr(ftt, name).decompress(blob, dictionary=d,
                                         device="cpu") == data
    assert getattr(ft, name).decompress(blob, dictionary=d) == data
    wbits = -15 if name == "flate" else 15
    assert pyzlib.decompressobj(wbits, zdict=d).decompress(blob) == data


def test_zlib_fdict_requires_dictionary():
    blob = ftt.zlib.compress(DATA, 1, dictionary=DICT, **SMALL)
    with pytest.raises(ftt.errors.BadZlibHeader):
        ftt.zlib.decompress(blob, device="cpu")


def test_decode_zlib_produced_dict_stream():
    c = pyzlib.compressobj(6, pyzlib.DEFLATED, 15, zdict=DICT)
    blob = c.compress(DATA) + c.flush()
    assert ftt.zlib.decompress(blob, None, True, DICT,
                               device="cpu") == DATA


def test_dictionary_over_32k():
    """Only the dictionary's last 32 KiB is history; the data repeats
    parts of it from near its end and from 32 KiB back."""
    d = corpus("mixed", 40000, seed=9)
    data = d[-300:] + d[-CTX:-CTX + 500] + corpus("text", 3000, seed=10)
    blob = _raw_with(data, d)
    want = ft.flate.decompress(blob, dictionary=d)
    assert want == data
    assert ftt.flate.decompress(blob, dictionary=d, device="cpu") == data
    z = pyzlib.compressobj(9, zdict=d)
    zb = z.compress(data) + z.flush()
    assert ftt.zlib.decompress(zb, dictionary=d, device="cpu") == data


def _literal_then_match(dist: int) -> bytes:
    """A raw fixed block: the literal "a", a match of length 3 at distance
    `dist` (1-4), the end of block."""
    def rev(v, n):
        return int(format(v, f"0{n}b")[::-1], 2)

    v = n = 0
    for val, width in [(1, 1), (1, 2), (rev(0x30 + 97, 8), 8),
                       (rev(1, 7), 7), (rev(dist - 1, 5), 5), (0, 7)]:
        v |= val << n
        n += width
    return v.to_bytes((n + 7) // 8, "little")


def test_literal_then_match_is_too_far_streams_raw():
    assert _literal_then_match(2) == too_far_streams()["RAW"]


@pytest.mark.parametrize("dist,dictionary", [
    (2, b""), (3, b"z"), (4, b"yz"), (3, b"yz"), (4, b"xyz"), (2, b"z")])
def test_match_before_the_dictionary(dist, dictionary):
    """The match at output byte 1 reaches dist - 1 bytes into the
    dictionary: past its start it raises InvalidMatch, as in JAX."""
    raw = _literal_then_match(dist)
    try:
        ref = ft.flate.decompress(raw, dictionary=dictionary)
    except ft.errors.InvalidMatch:
        assert len(dictionary) < dist - 1
        with pytest.raises(ftt.errors.InvalidMatch):
            ftt.flate.decompress(raw, dictionary=dictionary, device="cpu")
        return
    assert len(dictionary) >= dist - 1
    assert ftt.flate.decompress(raw, dictionary=dictionary,
                                device="cpu") == ref


@pytest.mark.parametrize("container", ["RAW", "ZLIB"])
def test_too_far_back_raises_as_jax(container):
    blob = too_far_streams()[container]
    ns, jns = ((ftt.flate, ft.flate) if container == "RAW"
               else (ftt.zlib, ft.zlib))
    with pytest.raises(ft.errors.InvalidMatch):
        jns.decompress(blob)
    with pytest.raises(ftt.errors.InvalidMatch):
        ns.decompress(blob, device="cpu")
    with pytest.raises(pyzlib.error, match="too far back"):
        pyzlib.decompress(blob, -15 if container == "RAW" else 15)


def test_too_far_back_in_a_reader():
    blob = too_far_streams()["ZLIB"]
    with pytest.raises(ftt.errors.InvalidMatch):
        ftt.zlib.decompress(io.BytesIO(blob), io.BytesIO(), device="cpu")


# ---------------------------------------------------------------------------
# the resolvers at hist_len 0 and k
# ---------------------------------------------------------------------------

def _word(kind: int, value: int = 0, dist: int = 1, adv: int = 8) -> int:
    return adv | (kind << 6) | (value << 8) | ((dist - 1) << 16)


# literal "a", a match of length 4 at distance 5, the end of block:
# 5 bytes of output whose match reads 4 bytes of history
ROW = [_word(i2.K_LIT, 97), _word(i2.K_MATCH, 1, 5), _word(i2.K_EOB)]
NEED = 4


def _ctx0() -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(
        corpus("random", CTX, seed=11), np.uint8).copy())


@pytest.mark.parametrize("hist_len", [0, 1, NEED - 1, NEED, 100, CTX])
@pytest.mark.parametrize("resolver", ["resolve", "resolve_compact"])
def test_resolvers_flag_matches_before_the_history(resolver, hist_len):
    words = torch.tensor([ROW + [0] * 5], dtype=torch.int32)
    counts = torch.tensor([len(ROW)], dtype=torch.int32)
    out_lens = torch.tensor([5], dtype=torch.int32)
    ctx0 = _ctx0()
    if resolver == "resolve":
        out, err = i2._resolve(words, counts, out_lens, ctx0, 1024,
                               hist_len)
    else:
        out, err = ai.resolve_compact(words, counts, out_lens, ctx0, S=1024,
                                      hist_len=hist_len)
    assert bool(err[0]) == (hist_len < NEED)
    if hist_len >= NEED:
        c = bytes(ctx0[-NEED:].numpy())
        assert bytes(out[:5].numpy()) == b"a" + c
