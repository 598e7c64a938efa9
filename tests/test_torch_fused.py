"""The single-program encode of the port (device="cpu") against the JAX
package: pipeline2.encode_core / encode_batch against the JAX
encode_batch(interpret=True) (words compared as u32, tbits and kind
equal), compress_device2(fused=True) against the JAX fused path byte for
byte, the port's fused bytes against its staged bytes, the fetchers and
helpers of the fused loop, and the public device checksums against the JAX
package's and zlib's.  Tolerance: exact everywhere.

The JAX single-jit references are made once, in a process of their own
(tests/_torch_fused_ref.py: ~55 s at levels 1 and 6); levels 7-9 take
minutes each and are marked slow, and the port is held to the sha256 of
their JAX outputs (HIGH_PINS) in the fast tier."""

import hashlib
import pathlib
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import checksum as j_checksum
from flate_tpu.jx import pipeline2 as j_pipeline2

from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import checksum, pipeline2

from _torch_corpora import CTX, KINDS, S, corpus, tt
from _torch_fused_ref import B, batch_inputs, fused_corpus

HERE = pathlib.Path(__file__).resolve().parent
WBITS = {"GZIP": 31, "ZLIB": 15, "RAW": -15}

torch.set_num_threads(1)         # the squeeze DP is thousands of tiny ops


# level -> (_batch_digest of the JAX encode_batch outputs on batch_inputs(),
# sha256 of the JAX compress_device2(fused=True) gzip bytes on
# fused_corpus()), made by tests/_torch_fused_ref.py
HIGH_PINS = {
    7: ("3e13aaf91795477c562bfceb3036eb8d40ff15eeabbcadcc46cfa9111f5cd8a6",
        "e4ae85370fa63aeffca1e8bb4b7504748e5ef11759abd9f72d773f3a1e4405d8"),
    8: ("13ddaedb6f96be83960e7b61482228d9719ec42aec7a1aa94bbb8b001026cfb2",
        "4636e3731503d66cfe346fc73a4b6e8367fc4d6dea83a9eb6fd0d45a3d340640"),
    9: ("433b71410b973ce69aaa0952811a393ea4519095b0ad3a20eaa1a771e5e6db87",
        "a967f99d133d7b1c63b0cb38c7ca292b4534c49ec088fabebd41b0b08b4d1286"),
}


def _batch_digest(words, tbits, kind) -> str:
    """sha256 of (words as u32, tbits, kind), each as int64 behind its
    shape."""
    h = hashlib.sha256()
    for a in (words, tbits, kind):
        a = np.asarray(a).astype(np.int64)
        h.update(repr(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def _jax_refs(tmp_path, levels):
    out = tmp_path / "ref.npz"
    r = subprocess.run(
        [sys.executable, str(HERE / "_torch_fused_ref.py"), str(out),
         *map(str, levels)], capture_output=True, timeout=1200,
        cwd=HERE.parent)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return _jax_refs(tmp_path_factory.mktemp("fused_ref"), (1, 6))


def _kern(level):
    return pipeline2.level_params(level, S)


def _port_batch(level, fn=pipeline2.encode_batch):
    args = [tt(x) for x in batch_inputs()]
    return fn(*args, S=S, ctx=CTX, **_kern(level))


def _u32(words):
    return words.numpy().astype(np.int64) & 0xFFFFFFFF


def _check_batch(ref, level, words, tbits, kind):
    np.testing.assert_array_equal(_u32(words), ref[f"words{level}"])
    np.testing.assert_array_equal(tbits.numpy(), ref[f"tbits{level}"])
    np.testing.assert_array_equal(kind.numpy(), ref[f"kind{level}"])


@pytest.mark.parametrize("level", [1, 6])
def test_encode_batch_equal_jax(jax_ref, level):
    _check_batch(jax_ref, level, *_port_batch(level))


@pytest.mark.parametrize("level", [1, 6])
def test_encode_core_equal_jax(jax_ref, level):
    """encode_core on windows primed by the caller, as the mesh primes
    them."""
    shards, ctx0, ctx_lens, valid, finals = (tt(x) for x in batch_inputs())
    windows = pipeline2._prime_windows(shards, ctx0, CTX)
    out = pipeline2.encode_core(windows, ctx_lens, valid, finals, S=S,
                                ctx=CTX, **_kern(level))
    _check_batch(jax_ref, level, *out)


@pytest.mark.parametrize("level", [1, 6])
def test_encode_batch_staged_equal(level):
    fused = _port_batch(level)
    staged = _port_batch(level, pipeline2.encode_batch_staged)
    for a, b in zip(fused, staged):
        assert torch.equal(a, b)


@pytest.mark.parametrize("level,container", [(1, "GZIP"), (6, "GZIP"),
                                             (6, "ZLIB")])
def test_fused_equal_jax(jax_ref, level, container):
    """Three batches of 3 (two in flight), the last one short; the Adler32
    path at level 6."""
    data = fused_corpus()
    out = pipeline2.compress_device2(
        data, level=level, container=Container[container], shard_len=S,
        ctx=CTX, batch=B, device="cpu", fused=True)
    assert out == jax_ref[f"{container.lower()}{level}"].tobytes()
    assert zlib.decompress(out, WBITS[container]) == data


def _both(data, level, container="GZIP", independent=False):
    kw = dict(level=level, container=Container[container], shard_len=S,
              ctx=CTX, batch=2, independent=independent, device="cpu")
    return (pipeline2.compress_device2(data, **kw),
            pipeline2.compress_device2(data, fused=True, **kw))


@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("container", ["GZIP", "ZLIB", "RAW"])
@pytest.mark.parametrize("level", [1, 3, 6])
def test_fused_equal_staged(level, container, independent):
    """Two batches with a tail shard: the host-built context carry against
    the staged path's device carry, every container, the FLT1 index."""
    data = corpus("mixed", 3 * S + 333, seed=level)
    staged, fused = _both(data, level, container, independent)
    assert fused == staged, (len(fused), len(staged))
    assert zlib.decompress(fused, WBITS[container]) == data


@pytest.mark.parametrize("n", [0, 1, 301])
def test_fused_tiny_inputs(n):
    data = corpus("text", n, seed=n) if n else b""
    staged, fused = _both(data, 6)
    assert fused == staged
    assert zlib.decompress(fused, 31) == data


def test_words_to_bytes_and_split_meta_equal_jax():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, (3, 2, 128), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(j_pipeline2._words_to_bytes(jnp.asarray(words)))
    got = pipeline2._words_to_bytes(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    meta = rng.integers(0, 1000, 3 * 4 + 1).astype(np.int32)
    for a, b in zip(pipeline2._split_meta(torch.from_numpy(meta)),
                    j_pipeline2._split_meta(jnp.asarray(meta))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("total", [0, 1, 1 << 17, (1 << 17) + 1,
                                   3 << 17, 5 << 17])
def test_byte_fetcher(total):
    buf = torch.from_numpy(np.random.default_rng(total).integers(
        0, 256, 5 << 17, dtype=np.uint8))
    got = pipeline2._ByteFetcher()(buf, total)
    np.testing.assert_array_equal(got, buf.numpy()[:total])


def test_fetcher_follows_the_rows_needed():
    """The first guess (16 rows) serves a short batch, a longer one takes
    more rows, and the guess follows the last need (a power of two)."""
    f = pipeline2._Fetcher()
    words = torch.arange(2 * 40 * 128, dtype=torch.int32).reshape(2, 40, 128)
    rows, tbits = f(words, torch.tensor([32 * 128 * 3, 8], dtype=torch.int32))
    assert rows.shape == (2, 4, 128) and f.guess_rows == 4
    np.testing.assert_array_equal(rows, words[:, :4].numpy())
    rows, _ = f(words, torch.tensor([32 * 128 * 20, 0], dtype=torch.int32))
    assert rows.shape == (2, 32, 128) and f.guess_rows == 32
    np.testing.assert_array_equal(rows, words[:, :32].numpy())
    rows, _ = f(words, torch.tensor([32 * 128 * 39, 0], dtype=torch.int32))
    assert rows.shape == (2, 40, 128)
    np.testing.assert_array_equal(tbits, [32 * 128 * 3, 8])


@pytest.mark.parametrize("kind", KINDS)
def test_checksum_shards_equal(kind):
    """crc32_shards / adler32_shards on ragged rows against the JAX
    package's and zlib's."""
    rows = np.frombuffer(corpus(kind, 3 * S, seed=9), np.uint8).reshape(3, S)
    lens = np.asarray([S, S - 17, 1], np.int64)
    rows = (rows * (np.arange(S)[None, :] < lens[:, None])).astype(np.uint8)
    crc = checksum.crc32_shards(rows, lens, device="cpu")
    adl = checksum.adler32_shards(rows, lens, device="cpu")
    np.testing.assert_array_equal(crc, j_checksum.crc32_shards(rows, lens))
    np.testing.assert_array_equal(adl, j_checksum.adler32_shards(rows, lens))
    for b in range(3):
        part = rows[b, :lens[b]].tobytes()
        assert int(crc[b]) == zlib.crc32(part)
        assert int(adl[b]) == zlib.adler32(part)


@pytest.mark.parametrize("n", [0, 1, 1000, 70001])
def test_device_checksums_equal(n):
    data = corpus("mixed", n, seed=n) if n else b""
    crc = checksum.crc32_device(data, device="cpu")
    adl = checksum.adler32_device(data, device="cpu")
    assert crc == j_checksum.crc32_device(data) == zlib.crc32(data)
    assert adl == j_checksum.adler32_device(data) == zlib.adler32(data)


def test_device_checksums_span_rows(monkeypatch):
    """Buffers over one row are hashed row by row and combined."""
    monkeypatch.setattr(checksum, "ROW", 4096)
    data = corpus("random", 3 * 4096 + 77, seed=4)
    assert checksum.crc32_device(data, device="cpu") == zlib.crc32(data)
    assert checksum.adler32_device(data, device="cpu") == zlib.adler32(data)


@pytest.mark.slow
@pytest.mark.parametrize("level", [7, 8, 9])
def test_encode_batch_equal_jax_high_levels(tmp_path, level):
    """Levels 7-9 (4 KiB parse blocks, the 3-byte K3 pass, deeper words):
    minutes of interpret-mode tracing each."""
    ref = _jax_refs(tmp_path, (level,))
    _check_batch(ref, level, *_port_batch(level))
    out = pipeline2.compress_device2(
        fused_corpus(), level=level, shard_len=S, ctx=CTX, batch=B,
        device="cpu", fused=True)
    assert out == ref[f"gzip{level}"].tobytes()
    assert HIGH_PINS[level] == (
        _batch_digest(*(ref[f"{k}{level}"] for k in ("words", "tbits",
                                                     "kind"))),
        hashlib.sha256(out).hexdigest())


@pytest.mark.parametrize("level", [7, 8, 9])
def test_high_levels_equal_pin(level):
    """Levels 7-9 against the pinned JAX outputs: encode_batch, and the
    member of compress_device2 fused and staged."""
    batch, member = HIGH_PINS[level]
    words, tbits, kind = _port_batch(level)
    assert _batch_digest(_u32(words), tbits.numpy(), kind.numpy()) == batch
    data = fused_corpus()
    for fused in (True, False):
        out = pipeline2.compress_device2(
            data, level=level, shard_len=S, ctx=CTX, batch=B, device="cpu",
            fused=fused)
        assert hashlib.sha256(out).hexdigest() == member, fused
    assert zlib.decompress(out, 31) == data
