"""Malformed streams through the port's decode on the CPU, against the JAX
package's verdicts.

- The reference's malformed-stream corpus (tests/data/fuzz, its table
  tests/test_inflate_fuzz.py CASES): each input through the port's one-shot
  and streaming raw decode must give the table's output or error class.
  chip_smoke.py keeps its own copy of the table (phase 17 runs the corpus
  on the card); it must equal CASES.
- Pinned streams (chip_smoke.py pinned_malformed, written there as bytes
  with how each was made): two one-bit flips of the port's own 167-byte
  gzip member, and a raw stream for each kind of error that once came out
  before a match reaching before the stream's start, which the serial
  decode meets first.
- Streams of more than one scanner chunk with a known first error
  (chip_smoke.py large_malformed_streams, cut to 300,000 bytes of input),
  also decoded as many chains (anyinflate.decompress_device_any at 32 KiB
  chunks).
- The port's decompress_cli on the corpus in this process: exit 0 or 1
  with the table's class, never 2 (its decoders disagree).
- The host classification of the symbol where a chain stops at the end of
  the body (anyinflate.stop_error) and the indexed route's check of what
  a shard holds after its data (inflate2._tail_ok).

A verdict is the output bytes or the error class name; tolerance: exact.
"""

import io
import sys
import types

import pytest
import torch

import flate_tpu as ft
from test_inflate_fuzz import CASES

import flate_tpu_torch as ftt
from flate_tpu_torch import errors
from flate_tpu_torch.cli import decompress_cli
from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import anyinflate as ai
from flate_tpu_torch.device import inflate2 as i2

import chip_smoke as cs

NS = {"RAW": "flate", "ZLIB": "zlib", "GZIP": "gzip"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def verdict(fn):
    """(bytes, None), or (None, the error class name) of either package."""
    try:
        return fn(), None
    except (errors.FlateError, ft.errors.FlateError) as e:
        return None, type(e).__name__


def port_verdicts(container: str, data: bytes):
    ns = getattr(ftt, NS[container])
    return (verdict(lambda: ns.decompress(data, device="cpu")),
            verdict(lambda: ns.decompressor(io.BytesIO(data),
                                            device="cpu").read_all()))


def jax_verdicts(container: str, data: bytes):
    """The JAX package's public decode on its host engine: one-shot and
    streaming."""
    ns = getattr(ft, NS[container])
    return (verdict(lambda: ns.decompress(data, device=False)),
            verdict(lambda: ns.decompressor(io.BytesIO(data)).read_all()))


def _want(name, expect, err, fuzz_dir):
    if isinstance(expect, str):
        expect = (fuzz_dir / expect).read_bytes()
    return (None, err.__name__) if err is not None else (expect, None)


@pytest.mark.parametrize("name,expect,err", CASES, ids=[c[0] for c in CASES])
def test_corpus_case(fuzz_dir, name, expect, err):
    data = (fuzz_dir / f"{name}.input").read_bytes()
    want = _want(name, expect, err, fuzz_dir)
    assert port_verdicts("RAW", data) == (want, want)


def test_chip_smoke_table_is_cases():
    assert cs.FUZZ_CASES == [
        (name, expect, None if err is None else err.__name__)
        for name, expect, err in CASES]


@pytest.mark.parametrize("case", cs.pinned_malformed(), ids=lambda c: c[0])
def test_pinned(case):
    name, container, data, expect = case
    want = (expect, None) if isinstance(expect, bytes) else (None, expect)
    assert jax_verdicts(container, data) == (want, want)
    assert port_verdicts(container, data) == (want, want)


def test_pinned_member_flips_zlib_agrees():
    """CPython's gzip on the two flips of the own member: the byte-38 flip
    (inside the index) decodes to the input, the byte-158 flip (the final
    stored block's NLEN) is rejected."""
    (_, _, flip38, text), (_, _, flip158, _) = cs.pinned_malformed()[:2]
    assert cs.python_accepts("GZIP", flip38) == text
    assert cs.python_accepts("GZIP", flip158) is None
    assert cs.python_accepts("GZIP", cs.OWN_GZIP_167) == text


@pytest.mark.parametrize("case", cs.large_malformed_streams(300_000),
                         ids=lambda c: c[0])
def test_large_malformed(case):
    name, container, data, cls = case
    want = (None, cls)
    assert jax_verdicts(container, data) == (want, want)
    assert port_verdicts(container, data) == (want, want)
    assert cs.python_accepts(container, data) is None
    # as many chains: a chunk entry every 32 KiB of the body
    i2.STATS.clear()
    assert verdict(lambda: ai.decompress_device_any(
        data, Container[container], chunk_bytes=1 << 15,
        device="cpu")) == want
    assert i2.STATS["chain_heads"] > 2


@pytest.mark.parametrize("name,expect,err", CASES, ids=[c[0] for c in CASES])
def test_decompress_cli_corpus(fuzz_dir, monkeypatch, capsys, name, expect,
                               err):
    data = (fuzz_dir / f"{name}.input").read_bytes()
    monkeypatch.setattr(sys, "stdin",
                        types.SimpleNamespace(buffer=io.BytesIO(data)))
    rc = decompress_cli.main(["--device", "cpu"])
    out = capsys.readouterr()
    want = _want(name, expect, err, fuzz_dir)
    if err is not None:
        assert (rc, out.out.split()) == (1, ["ERR", err.__name__]), out.err
    else:
        assert (rc, out.out.split()) == (0, ["OK", str(len(want[0]))]), \
            out.err


# ---------------------------------------------------------------------------
# the symbol where a chain stops at the body's end
# ---------------------------------------------------------------------------

def _bits(fields) -> bytes:
    """LSB-first fields [(value, width)]; a Huffman code is given
    bit-reversed (its first bit lowest)."""
    v = n = 0
    for val, width in fields:
        v |= val << n
        n += width
    return v.to_bytes((n + 7) // 8, "little")


def _rev(v: int, n: int) -> int:
    return int(format(v, f"0{n}b")[::-1], 2)


LIT_A = (_rev(0x30 + 65, 8), 8)            # fixed code of literal "A"
LIT_FF = (_rev(0x190 + 255 - 144, 9), 9)   # fixed code of literal 0xFF
MATCH = [(_rev(1, 7), 7), (_rev(0, 5), 5)]  # length 3 (257), distance 1
FIXED = [(0, 1), (1, 2)]                   # a non-final fixed block


# Each body is a fixed block of "A" then `tail`, whole bytes unless said:
# the symbol at `bit` is the first one the body does not hold whole.
@pytest.mark.parametrize("tail,bit,cls", [
    # litlen symbol 286 (8-bit code 11000110): invalid once read
    ([(_rev(0xC6, 8), 8)], 11, "InvalidCode"),
    # the body ends after 5 bits of a literal's 8-bit code
    ([(_rev(0x30 + 65, 8) & 0x1F, 5)], 11, "EndOfStream"),
    # length 11 (code 265, 7 bits) ends the body: its extra bit is cut,
    # though a distance code read from zeros would be valid
    (MATCH + [LIT_FF, LIT_FF, (_rev(9, 7), 7)], 41, "EndOfStream"),
    # distance code 30 (11110) after a whole length code: invalid
    ([(_rev(1, 7), 7), (_rev(30, 5), 5), (0, 4)], 11, "InvalidCode"),
    # distance code 4 (distances 5-6) ends the body: its extra bit is cut
    ([LIT_FF, (_rev(1, 7), 7), (_rev(4, 5), 5)], 20, "EndOfStream"),
])
def test_stop_error(tail, bit, cls):
    body = _bits(FIXED + [LIT_A] + tail)
    p = ai.plan_block_at(body, 0)
    assert type(ai.stop_error(body, p, bit)).__name__ == cls
    # the serial decode of the body meets the same error there
    assert verdict(lambda: ft.flate.decompress(body, device=False)) \
        == (None, cls)
    assert port_verdicts("RAW", body) == ((None, cls), (None, cls))


def test_stop_error_on_a_whole_symbol_raises():
    body = _bits(FIXED + [LIT_A, LIT_A])
    with pytest.raises(RuntimeError):
        ai.stop_error(body, ai.plan_block_at(body, 0), 3)


# ---------------------------------------------------------------------------
# what an indexed shard holds after its data
# ---------------------------------------------------------------------------

SYNC = b"\x00\x00\xff\xff"                 # LEN 0, NLEN 0xFFFF


@pytest.mark.parametrize("sh,bit,final,last,ok", [
    (b"\xaa\x00" + SYNC, 13, False, False, True),     # block, sync marker
    (b"\xaa\x20" + SYNC, 13, False, True, True),      # final sync marker
    (b"\xaa\x20" + SYNC, 13, False, False, False),    # final, shard not last
    (b"\xaa\x00" + SYNC, 13, False, True, False),     # last, never final
    (b"\xaa\x00\x00\x00\xfe\xff", 13, False, False, False),   # bad NLEN
    (b"\xaa\x00\x01\x00\xfe\xffz", 13, False, False, False),  # stored data
    (b"\xaa\x40" + SYNC, 13, False, False, False),    # a coded block
    (b"\xaa\x00" + SYNC + b"\x00", 13, False, False, False),  # a byte over
    (b"\xaa\x00" + SYNC[:3], 13, False, False, False),        # cut marker
    (b"\xaa\xaa", 16, False, False, True),            # ends at the shard's
    (b"\xaa\xaa", 12, True, True, True),              # final, last byte
    (b"\xaa\xaa", 5, True, True, False),              # final, a byte early
    (b"\xaa\xaa", 12, True, False, False),            # final, not last
])
def test_tail_ok(sh, bit, final, last, ok):
    assert i2._tail_ok(sh, bit, final, last) is ok
