"""The port's public surface against the JAX package's
(tests/test_interface.py): the three container namespaces expose the same
names, every entry point works on the CPU, and the huffman / store modes
write the JAX package's bytes.  Tolerance: exact (bytes).
"""

import io

import pytest
import torch

import flate_tpu as ft

import flate_tpu_torch as ftt
from flate_tpu_torch import consts

SURFACE = ["compress", "decompress", "compressor", "decompressor",
           "Compressor", "Decompressor", "huffman", "store"]
SUB_SURFACE = ["compress", "decompress", "compressor", "decompressor"]
NAMES = ["flate", "gzip", "zlib"]
SMALL = dict(device="cpu", shard_len=4096, ctx=1024, batch=2)
DATA = b"interface conformance payload " * 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_surface_complete(name):
    ns = getattr(ftt, name)
    for attr in SURFACE:
        assert hasattr(ns, attr), attr
    for sub in (ns.huffman, ns.store):
        for attr in SUB_SURFACE:
            assert hasattr(sub, attr), attr
    assert ns.Compressor is ftt.Compressor
    assert ns.Decompressor is ftt.Decompressor


@pytest.mark.parametrize("name", NAMES)
def test_every_entry_point_works(name):
    ns = getattr(ftt, name)
    assert ns.decompress(ns.compress(DATA, **SMALL), device="cpu") == DATA

    out = io.BytesIO()
    c = ns.compressor(out, level=5, **SMALL)
    c.write(DATA)
    c.finish()
    d = ns.decompressor(io.BytesIO(out.getvalue()), device="cpu")
    assert d.read_all() == DATA

    for sub in (ns.huffman, ns.store):
        assert sub.decompress(sub.compress(DATA), device="cpu") == DATA
        out = io.BytesIO()
        c = sub.compressor(out)
        c.write(DATA)
        c.finish()
        assert ns.decompress(out.getvalue(), device="cpu") == DATA
        assert sub.decompressor(out.getvalue(), device="cpu").read() == DATA


def _modes(name: str, mode: str, data: bytes, writes=None,
           flush_at=None) -> tuple:
    """(port bytes, JAX bytes) of one huffman or store stream: one-shot,
    or a compressor fed `writes` with a flush after write `flush_at`."""
    port, jax = getattr(ftt, name), getattr(ft, name)
    if writes is None:
        return (getattr(port, mode).compress(data),
                getattr(jax, mode).compress(data))
    outs = []
    for ns in (port, jax):
        out = io.BytesIO()
        c = getattr(ns, mode).compressor(out)
        for i, w in enumerate(writes):
            c.write(w)
            if i == flush_at:
                c.flush()
        c.flush()
        c.finish()
        outs.append(out.getvalue())
    return tuple(outs)


def _payload(n: int) -> bytes:
    from _torch_corpora import corpus
    return corpus("mixed", n, seed=31)


@pytest.mark.parametrize("mode", ["huffman", "store"])
@pytest.mark.parametrize("name", NAMES)
def test_sub_mode_bytes_equal_jax(name, mode):
    """One-shot over 0, 1, 20,000 and 300,000 bytes (three shards of
    128 KiB, the stored ones cut at 65,535), and a compressor with
    flushes: the JAX package's bytes, which decode on the port (the
    300,000-byte literal-only blocks, 128 K symbols each, only on the
    card: tests/test_torch_cuda.py)."""
    big = _payload(300_000)
    for data in (b"", b"x", big[:20_000], big):
        port, jax = _modes(name, mode, data)
        assert port == jax
        if mode == "store" or len(data) <= 20_000:
            assert getattr(ftt, name).decompress(port, device="cpu") == data
    port, jax = _modes(name, mode, b"", writes=[big[:5000], b"", big[:9000]],
                       flush_at=0)
    assert port == jax
    assert getattr(ftt, name).decompress(port, device="cpu") \
        == big[:5000] + big[:9000]


def test_sub_mode_reader_and_meta():
    from flate_tpu.containers import GzipMetadata as JMeta
    data = _payload(150_000)
    meta = ftt.GzipMetadata(filename=b"a.txt", mtime=7)
    port = ftt.gzip.huffman.compress(io.BytesIO(data), meta=meta)
    jax = ft.gzip.huffman.compress(io.BytesIO(data),
                                   meta=JMeta(filename=b"a.txt", mtime=7))
    assert port == jax
    out = io.BytesIO()
    assert ftt.zlib.store.compress(data, out) is None
    assert out.getvalue() == ft.zlib.store.compress(data)


def test_level_aliases():
    assert consts.LEVEL_FAST == 4
    assert consts.LEVEL_DEFAULT == 6
    assert consts.LEVEL_BEST == 9
    data = b"alias levels " * 50
    for lv in (consts.LEVEL_FAST, consts.LEVEL_DEFAULT, consts.LEVEL_BEST):
        blob = ftt.flate.compress(data, lv, **SMALL)
        assert ftt.flate.decompress(blob, device="cpu") == data


def test_no_card_raises():
    """Without a card the entry points and the Decompressor raise; they
    never fall back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(ftt.errors.DeviceUnavailable):
        ftt.gzip.decompressor(b"")
    with pytest.raises(ftt.errors.DeviceUnavailable):
        ftt.Decompressor(io.BytesIO(b""))
    with pytest.raises(ftt.errors.DeviceUnavailable):
        ftt.zlib.decompress(b"")
