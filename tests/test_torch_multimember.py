"""Concatenated members through the port's public decode on the CPU, against
the JAX package's public decode: every member of every container is read,
and bytes after a member that are not one raise the JAX error class.

A member with the FLT1 index takes the indexed route, any other member the
chained route, member by member.  Tolerance: exact (bytes and error class).
"""

import gzip as pygzip
import io
import zlib

import pytest
import torch

import flate_tpu as ft

import flate_tpu_torch as ftt
from flate_tpu_torch.device import inflate2 as i2

from _torch_corpora import c12_stream, corpus

A = b"hello world " * 1000
B = b"second member " * 500
SMALL = dict(device="cpu", shard_len=4096, ctx=1024, batch=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain walks are many tiny tensor ops: one intra-op thread runs
    them faster, and keeps parallel test workers off each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn):
    try:
        return fn()
    except ft.errors.FlateError as e:
        return type(e).__name__
    except ftt.errors.FlateError as e:
        return type(e).__name__


def _same_as_jax(name: str, blob: bytes):
    """The port's result (bytes or error class) and the JAX package's."""
    got = _outcome(lambda: getattr(ftt, name).decompress(blob,
                                                         device="cpu"))
    want = _outcome(lambda: getattr(ft, name).decompress(blob))
    return got, want


def _raw(data: bytes, level: int = 6) -> bytes:
    return zlib.compress(data, level)[2:-4]


STREAMS = {
    "zlib_two": ("zlib", zlib.compress(A) + zlib.compress(B)),
    "zlib_three": ("zlib", zlib.compress(A, 1) + zlib.compress(b"", 6)
                   + zlib.compress(B, 9)),
    "raw_two": ("flate", _raw(A) + _raw(B)),
    "gzip_two": ("gzip", pygzip.compress(A) + pygzip.compress(B)),
    "zlib_junk": ("zlib", zlib.compress(A) + b"junk"),
    "gzip_zeros": ("gzip", pygzip.compress(A) + b"\0\0\0"),
    "raw_c12": ("flate", c12_stream()),
    "empty_zlib": ("zlib", b""),
    "empty_gzip": ("gzip", b""),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_members_as_jax(name):
    container, blob = STREAMS[name]
    got, want = _same_as_jax(container, blob)
    assert got == want


def test_two_zlib_members_give_every_byte():
    got = ftt.zlib.decompress(zlib.compress(A) + zlib.compress(B),
                              device="cpu")
    assert got == A + B and len(got) == 19_000


def test_trailing_bytes_raise_jax_class():
    with pytest.raises(ftt.errors.BadZlibHeader):
        ftt.zlib.decompress(zlib.compress(A) + b"junk", device="cpu")
    with pytest.raises(ftt.errors.EndOfStream):
        ftt.gzip.decompress(pygzip.compress(A) + b"\0\0\0", device="cpu")
    with pytest.raises(ftt.errors.InvalidBlockType):
        ftt.flate.decompress(_raw(A) + b"\xff", device="cpu")


@pytest.mark.parametrize("name", ["flate", "zlib", "gzip"])
def test_own_reset_members(name):
    """The port's compressor, finish(), reset(), finish(): two members,
    both decoded, by the port and by the JAX package."""
    out = io.BytesIO()
    c = getattr(ftt, name).compressor(out, 3, **SMALL)
    c.write(A)
    c.finish()
    c.reset()
    c.write(B)
    c.finish()
    blob = out.getvalue()
    assert getattr(ftt, name).decompress(blob, device="cpu") == A + B
    assert getattr(ft, name).decompress(blob) == A + B


def test_each_member_takes_its_own_route():
    """An indexed member, a foreign member, an indexed member: two go the
    indexed route, one the chained route, and a foreign member no longer
    sends the indexed ones to the chained route."""
    x, y = corpus("text", 30000, seed=1), corpus("mixed", 20000, seed=2)
    z = corpus("text", 20000, seed=5)
    blob = (ftt.gzip.compress(x, 1, **SMALL) + pygzip.compress(y)
            + ftt.gzip.compress(z, 3, **SMALL))
    i2.STATS.clear()
    assert ftt.gzip.decompress(blob, device="cpu") == x + y + z
    assert i2.STATS["chained_members"] == 1
    assert i2.STATS["segmented_reroutes"] == 0
    assert i2.STATS["decode_batch2"] == 2
    assert ft.gzip.decompress(blob) == x + y + z


def test_indexed_device_function_reads_every_member():
    x = corpus("text", 9000, seed=3)
    blob = ftt.gzip.compress(x, 1, **SMALL) * 3
    assert i2.decompress_device(blob, batch=2, device="cpu") == x * 3
