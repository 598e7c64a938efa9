"""Every other member chip_smoke.py encodes on the card, held to the JAX
package's bytes (chip_smoke.py ROUTE_PINNED): the streaming compressor,
the zlib member with a preset dictionary, the round-1 encoder and its
mesh, the 32 MiB members of levels 1 and 3 and the text corpus at levels
1, 3, 6 and 9, all at the headline's shard shape (128 KiB shards, 32 KiB
of context).  At that shape matches reach up to 32 KiB back, which the
small-shape tests of these routes never emit (distance codes 26-29).

Fast: the port's device="cpu" bytes of the pins whose port side is short
(the round-1 encoder on 2 shards + 12,345 B, the dictionary pair, the
text corpus at level 1), and a streaming zlib compressor with a 32 KiB
dictionary and a flush at the same shape (DICT_STREAM_PINS).  Slow: every
pin recomputed by the JAX package (its Pallas kernels in interpret mode;
11 s to 31 minutes a case on the CPU, the 32 MiB ones and text at level 9
the longest), and the port's CPU bytes of the big pins (minutes each, the
32 MiB ones ~12 GiB).  Tolerance: none, the bytes are equal or the case
fails."""

import hashlib
import zlib

import pytest
import torch

import _torch_route_ref as rr
from chip_smoke import (B, PROD_PINNED, ROUTE_INPUTS, ROUTE_PINNED, S,
                        STREAM_CUT, prod_input, route_input, text_corpus)

torch.set_num_threads(1)         # the squeeze DP is thousands of tiny ops

FAST = ("round1s-l1", "round1s-l6", "round1s-l9", "fdict-l6", "nodict-l6",
        "text-l1")
# rr.port_dict_stream's (member, flushed prefix) by level: length, sha256
# of the JAX package's zlib.compressor on the same writes
DICT_STREAM_PINS = {
    (1, "member"): (
        131_637,
        "59ae984d6b4d0e36fd33e1c3b3c2b17edd2426838bf81f28b2442ff3f18dc0ce"),
    (1, "flushed"): (
        59_462,
        "b2ceddebcfd8b14503685e2477a07e222a548eee11e73451740d48a6d3912758"),
    (6, "member"): (
        112_151,
        "c9e286116520dddb600e0ee1930fc237ac24a45ec8cdfa44f23adace77bdc485"),
    (6, "flushed"): (
        46_889,
        "29e9efd93d89066e3f14dc69f4bbde0c5ca3b848971b9c217462bc493d5571f9"),
}


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def decodes(case: str, blob: bytes) -> bool:
    data = route_input(ROUTE_PINNED[case][0])
    if case.startswith("fdict"):
        d = zlib.decompressobj(zdict=text_corpus(32 * 1024))
        return d.decompress(blob) == data and d.eof
    if case.startswith("nodict"):
        return zlib.decompress(blob) == data
    if case.endswith("-flushed"):
        return zlib.decompressobj(31).decompress(blob) == data[:STREAM_CUT]
    return zlib.decompress(blob, 31) == data


def check(case: str, blob: bytes) -> None:
    """blob is the pinned member, and it decodes to the case's input."""
    _inp, _call, n, pin = ROUTE_PINNED[case]
    assert (len(blob), sha(blob)) == (n, pin)
    assert decodes(case, blob)


def test_route_pins_table():
    """The cases the card encodes, each with its JAX call, length and
    sha256; the inputs' lengths, and the prefixes they share with one
    another and with PROD_PINNED's."""
    want = {"stream32M-l6", "stream32M-l6-flushed", "fdict-l6", "nodict-l6",
            "pigz-l6", "mixed32M-l1", "mixed32M-l3",
            *(f"round1{s}-l{L}" for s in ("", "s") for L in (1, 6, 9)),
            *(f"text-l{L}" for L in (1, 3, 6, 9))}
    assert set(ROUTE_PINNED) == want
    for case, (inp, call, n, pin) in ROUTE_PINNED.items():
        assert inp in ROUTE_INPUTS and call and n > 0 and len(pin) == 64
    lens = {k: len(route_input(k)) for k in ROUTE_INPUTS}
    assert lens == {"mixed32M": 32 << 20, "text": 3_359_630,
                    "text4": 4 * 32 * 1024, "r1": (8 << 20) + 12_345,
                    "r1s": 2 * S + 12_345, "pigz": (2 << 20) + 12_345}
    big, r1 = route_input("mixed32M"), route_input("r1")
    assert big == prod_input("mixed32M") and big[:B * S] == r1[:B * S]
    assert r1.startswith(rr.dict_stream_input()[0])
    for k in ("r1s", "pigz"):
        assert r1.startswith(route_input(k))
    text = route_input("text")
    assert route_input("text4") == text[:32 * 1024] * 4
    assert text.startswith(prod_input("text"))
    flushed, member = (ROUTE_PINNED[c][2] for c in ("stream32M-l6-flushed",
                                                     "stream32M-l6"))
    assert 0 < flushed < member
    assert ROUTE_PINNED["fdict-l6"][2] < ROUTE_PINNED["nodict-l6"][2]
    assert set(PROD_PINNED).isdisjoint(ROUTE_PINNED)


@pytest.mark.parametrize("case", FAST)
def test_port_bytes_equal_route_pin(case):
    """The dictionary pair at batch 2, not the card's 64 (the squeeze pads
    a batch to its width, 6 minutes a member on the CPU): its one shard
    still waits in the buffer for finish(), as at 64; the slow test below
    runs batch 64."""
    kw = {"batch": 2} if case in ("fdict-l6", "nodict-l6") else {}
    check(case, rr.port_route(case, "cpu", **kw))


@pytest.mark.parametrize("level", (1, 6))
def test_dict_stream_equal_pin(level):
    """zlib.compressor(dictionary=32 KiB text) at 128 KiB shards in batches
    of 2, written in pieces cut at DICT_CUTS with a flush after the second:
    matches into the dictionary and across the flush reach 32 KiB back."""
    member, flushed = rr.port_dict_stream(level, "cpu")
    got = {"member": member, "flushed": flushed}
    for part, blob in got.items():
        assert (len(blob), sha(blob)) == DICT_STREAM_PINS[level, part]
    data, zd = rr.dict_stream_input()
    d = zlib.decompressobj(zdict=zd)
    assert d.decompress(flushed) == data[:rr.DICT_CUTS[1]]
    d = zlib.decompressobj(zdict=zd)
    assert d.decompress(member) == data and d.eof


@pytest.mark.slow
@pytest.mark.parametrize("case", list(ROUTE_PINNED))
def test_jax_bytes_equal_route_pin(case):
    """The pins recomputed by the JAX package."""
    check(case, rr.jax_route(case))


@pytest.mark.slow
@pytest.mark.parametrize("case", [c for c in ROUTE_PINNED if c not in FAST]
                         + ["fdict-l6", "nodict-l6"])
def test_port_big_bytes_equal_route_pin(case):
    check(case, rr.port_route(case, "cpu"))


@pytest.mark.slow
@pytest.mark.parametrize("level", (1, 6))
def test_jax_dict_stream_equal_pin(level):
    member, flushed = rr.jax_dict_stream(level)
    assert (len(member), sha(member)) == DICT_STREAM_PINS[level, "member"]
    assert (len(flushed), sha(flushed)) == DICT_STREAM_PINS[level, "flushed"]
