"""The plain reference against CPython's zlib, and its check of a member
against broken members."""

import ast
import gzip
import os
import pathlib
import zlib

import pytest

from gpubench.corpora import mixed, text
from gpubench.reference import checksums
from gpubench.reference.inflate import DeflateError, inflate
from gpubench.reference.member import check_member

HERE = pathlib.Path(__file__).resolve().parent
DATA = mixed.make(300_000, 5) + text.make(100_000, 7)


def raw(data, level, strategy=zlib.Z_DEFAULT_STRATEGY):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_inflate_equals_zlib(level):
    z = raw(DATA, level)
    out, pos, final = inflate(z)
    assert out == DATA and final and (pos + 7) // 8 == len(z)


@pytest.mark.parametrize("strategy", [zlib.Z_FIXED, zlib.Z_HUFFMAN_ONLY,
                                      zlib.Z_RLE])
def test_inflate_block_kinds(strategy):
    z = raw(DATA[:50_000], 6, strategy)
    assert inflate(z)[0] == DATA[:50_000]


def test_inflate_with_history_and_stop():
    """A stream cut at a sync flush decodes to the flush with the stop bit,
    and its rest with the first part as history."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    a = co.compress(DATA[:70_000]) + co.flush(zlib.Z_SYNC_FLUSH)
    b = co.compress(DATA[70_000:140_000]) + co.flush()
    out, pos, final = inflate(a, stop_bit=8 * len(a))
    assert out == DATA[:70_000] and pos == 8 * len(a) and not final
    assert inflate(b, DATA[:70_000])[0] == DATA[70_000:140_000]
    with pytest.raises(DeflateError):
        inflate(b)                   # its matches reach into the history
    with pytest.raises(DeflateError):
        inflate(a, stop_bit=8 * len(a) - 8)


@pytest.mark.parametrize("cut", [1, 100, 5000])
def test_inflate_rejects_cut_and_broken_streams(cut):
    z = raw(DATA[:100_000], 6)
    with pytest.raises(DeflateError):
        inflate(z[:-cut])
    with pytest.raises(DeflateError):
        inflate(b"\x07" + z[1:])     # block type 3


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 100_000, 1_234_567])
def test_checksums_equal_zlib(n):
    d = os.urandom(n)
    assert checksums.crc32(d) == zlib.crc32(d)
    assert checksums.adler32(d) == zlib.adler32(d)


def test_check_member_passes_sound_members():
    for member, container in ((gzip.compress(DATA, 6, mtime=0), "gzip"),
                              (zlib.compress(DATA, 6), "zlib"),
                              (raw(DATA, 6), "raw")):
        res = check_member(member, DATA, container, index=False)
        assert res == {"bytes_wrong": 0, "framing_errors": 0,
                       "first_error": None}, container


def test_check_member_counts_faults():
    m = gzip.compress(DATA, 6, mtime=0)
    flipped = m[:1000] + bytes([m[1000] ^ 0x10]) + m[1001:]
    assert check_member(flipped, DATA, "gzip", False)["bytes_wrong"] > 0
    bad_crc = m[:-8] + bytes([m[-8] ^ 1]) + m[-7:]
    assert check_member(bad_crc, DATA, "gzip", False)["framing_errors"] == 1
    half = gzip.compress(DATA[:len(DATA) // 2], 6, mtime=0)
    assert check_member(half, DATA, "gzip", False)["bytes_wrong"] > 0
    # the configuration asks for the FLT1 index, which CPython writes not
    assert check_member(m, DATA, "gzip", True)["framing_errors"] == 1


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in {
                    "torch", "jax", "jaxlib", "flax", "flate_tpu",
                    "flate_tpu_torch", "zlib", "gzip"}, (path, name)
