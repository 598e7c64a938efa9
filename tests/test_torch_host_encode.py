"""The port's host encode modules against the JAX package's, on the CPU:
huffman.py (the host C `huff_lengths`), bitpack.py, block.py and
deflate.py (the tail encoder, with the host C `optimal_parse` DP).  The JAX side runs its own native C, which must have
loaded: with it missing the JAX squeeze quietly does nothing, and its
bytes at levels 4-9 would not be the reference.  Tolerance: exact
(integers, tokens and bytes)."""

import zlib

import numpy as np
import pytest

from flate_tpu import bitpack as j_bitpack
from flate_tpu import block as j_block
from flate_tpu import deflate as j_deflate
from flate_tpu import huffman as j_huffman
from flate_tpu import native as j_native

from flate_tpu_torch import _build, bitpack, block, deflate, huffman

from _torch_corpora import corpus


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    assert j_native._load("fastparse") is not None
    assert j_native._load("fasthuff") is not None


def _fib_freqs(n: int) -> np.ndarray:
    """Fibonacci-skewed frequencies: optimal Huffman depths reach n - 1,
    past any 15-bit (or 7-bit) limit, so package-merge runs."""
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return np.array(f[:n], dtype=np.int64)


def _freq_cases():
    rng = np.random.default_rng(5)
    cases = {}
    for i, (n, hi) in enumerate([(286, 5000), (30, 300), (19, 50),
                                 (286, 3), (286, 1 << 20)]):
        f = rng.integers(0, hi, n).astype(np.int64)
        f[rng.random(n) < 0.3] = 0
        cases[f"random{i}"] = (f, 15 if n != 19 else 7)
    fib = np.zeros(286, dtype=np.int64)
    fib[rng.permutation(286)[:40]] = _fib_freqs(40)
    cases["fibonacci_ll"] = (fib, 15)
    cases["fibonacci_cg"] = (_fib_freqs(19), 7)
    cases["fibonacci_tail"] = (np.concatenate([_fib_freqs(25), np.zeros(5,
                                               np.int64)]), 15)
    for used in (0, 1, 2):
        f = np.zeros(30, dtype=np.int64)
        f[[3, 17][:used]] = [9, 4][:used]
        cases[f"used{used}"] = (f, 15)
    return cases


FREQS = _freq_cases()


@pytest.mark.parametrize("case", list(FREQS))
def test_huffman_code_lengths_equal(case):
    freq, max_bits = FREQS[case]
    want = j_huffman.huffman_code_lengths(freq, max_bits)
    got = huffman.huffman_code_lengths(freq, max_bits)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case.startswith("fibonacci"):
        assert int(want.max()) == max_bits
    codes, lens = huffman.build_codes(freq, max_bits)
    j_codes, _ = j_huffman.build_codes(freq, max_bits)
    np.testing.assert_array_equal(codes, j_codes)
    assert huffman.bit_length(freq, lens) == j_huffman.bit_length(freq, lens)


@pytest.mark.parametrize("freq, max_bits", [
    (np.ones(9, np.int64), 3), (_fib_freqs(40), 5),
    (np.r_[np.zeros(20, np.int64), _fib_freqs(33)], 5)],
    ids=["flat9_3bits", "fib40_5bits", "fib33_5bits"])
def test_huffman_code_lengths_refuse_as_jax(freq, max_bits):
    """More used symbols than max_bits-bit codes can hold: the JAX
    package refuses (its package-merge asserts), and the port's host C
    refuses and the port raises ValueError."""
    with pytest.raises(AssertionError):
        j_huffman.huffman_code_lengths(freq, max_bits)
    with pytest.raises(ValueError):
        huffman.huffman_code_lengths(freq, max_bits)


def test_huffman_code_lengths_refuse_past_host_alphabet():
    """The host C takes at most 320 symbols (deflate's alphabets are 286,
    30 and 19): a larger alphabet raises, with no second implementation
    to carry on."""
    with pytest.raises(ValueError, match="320"):
        huffman.huffman_code_lengths(np.ones(321, np.int64), 15)


def test_host_library_build_failure_raises(tmp_path, monkeypatch):
    """A host C that does not compile raises; nothing carries on without
    the library."""
    bad = tmp_path / "host_encode.c"
    bad.write_text("int huff_lengths(void) { return ; syntax error }\n")
    monkeypatch.setattr(_build, "HOST_SOURCE", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="cc failed"):
        _build.host_library.__wrapped__()
    assert not list((tmp_path / "build").glob("*.so"))


def test_optimal_parse_equal():
    data = np.frombuffer(corpus("text", 20000, seed=2), np.uint8)
    for level in (4, 6, 9):
        K = j_deflate.consts.LEVEL_PARAMS[level][0]
        mlen, mdist = j_deflate.find_matches(data, 0, K)
        rng = np.random.default_rng(level)
        lit = rng.integers(4, 14, 256).astype(np.float32)
        lenc = rng.integers(5, 16, 29).astype(np.float32) + 0.5
        dst = rng.integers(5, 20, 30).astype(np.float32) + 0.25
        want = j_native.optimal_parse(mlen, mdist, data, lit, lenc, dst)
        got = deflate.optimal_parse(mlen, mdist, data, lit, lenc, dst)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _shard_cases():
    text = np.frombuffer(corpus("text", 24000, seed=3), np.uint8)
    mixed = np.frombuffer(corpus("mixed", 9000, seed=4), np.uint8)
    return {"text": (text[8000:], text[:8000]),
            "mixed": (mixed[3000:], mixed[:3000])}


SHARDS = _shard_cases()


@pytest.mark.parametrize("with_ctx", [False, True], ids=["noctx", "ctx"])
@pytest.mark.parametrize("level", range(1, 10))
def test_tokenize_shard_and_write_block_equal(level, with_ctx):
    name = "text" if level % 2 else "mixed"
    data, ctx = SHARDS[name]
    ctx = ctx if with_ctx else None
    want = j_deflate.tokenize_shard(data, ctx, level)
    got = deflate.tokenize_shard(data, ctx, level)
    for k in ("lit", "length", "dist"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    sink, j_sink = bitpack.BitSink(), j_bitpack.BitSink()
    block.write_block(sink, got, final=True, raw=data.tobytes())
    j_block.write_block(j_sink, want, final=True, raw=data.tobytes())
    assert sink.getvalue() == j_sink.getvalue()
    d = zlib.decompressobj(-15, zdict=b"" if ctx is None else ctx.tobytes())
    assert d.decompress(sink.getvalue()) == data.tobytes()


def test_find_matches_and_lazy_parse_equal():
    data = np.frombuffer(corpus("text", 12000, seed=6), np.uint8)
    for start, K in ((0, 8), (4000, 64), (11990, 4)):
        got = deflate.find_matches(data, start, K)
        want = j_deflate.find_matches(data, start, K)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for lazy, max_lazy in ((False, 0), (True, 32)):
            np.testing.assert_array_equal(
                deflate.lazy_parse(got[0], got[1], lazy, max_lazy),
                j_deflate.lazy_parse(want[0], want[1], lazy, max_lazy))
    with pytest.raises(ValueError):
        deflate.tokenize_shard(data, None, 0)


def test_bitsink_equal():
    rng = np.random.default_rng(7)
    sinks = [bitpack.BitSink(), j_bitpack.BitSink()]
    for step in range(40):
        n = int(rng.integers(0, 30))
        nbits = rng.integers(0, 49, n)
        vals = (rng.integers(0, 1 << 62, n).astype(np.uint64)
                & ((np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1)))
        words, tbits = bitpack.pack_bits_np(vals, nbits)
        j_words, j_tbits = j_bitpack.pack_bits_np(vals, nbits)
        np.testing.assert_array_equal(words, j_words)
        assert tbits == j_tbits
        for s in sinks:
            if step % 3 == 0:
                s.append_fields(vals, nbits)
            elif step % 3 == 1:
                s.append_packed(words.copy(), tbits)
            else:
                s.align_to_byte()
                s.append_bytes(bytes([step, 255 - step]))
        assert sinks[0].getvalue() == sinks[1].getvalue()
        assert sinks[0].bit_length == sinks[1].bit_length
    sinks[0].append_fields(np.array([1], np.uint64), np.array([3]))
    with pytest.raises(bitpack.UnfinishedBits):
        sinks[0].append_bytes(b"x")


def test_block_helpers_equal():
    data = np.frombuffer(corpus("text", 70000, seed=8), np.uint8)
    toks = j_deflate.tokenize_shard(data[:5000], None, 3)
    for a, b in zip(block.token_histograms(toks),
                    j_block.token_histograms(toks)):
        np.testing.assert_array_equal(a, b)
    freq_ll, freq_d = j_block.token_histograms(toks)
    ll = j_huffman.huffman_code_lengths(freq_ll, 15)
    d = j_huffman.huffman_code_lengths(freq_d, 15)
    assert block.generate_codegen(ll, d) == j_block.generate_codegen(ll, d)
    assert block.fixed_size(freq_ll, freq_d) == \
        j_block.fixed_size(freq_ll, freq_d)
    for n, pos in ((0, 0), (1, 5), (65535, 3), (65536, 0), (200000, 7)):
        assert block.stored_size(n, pos) == j_block.stored_size(n, pos)
    raw = data.tobytes()
    for fn in ("write_stored", "write_huffman_only"):
        sink, j_sink = bitpack.BitSink(), j_bitpack.BitSink()
        sink.append_fields(np.array([5], np.uint64), np.array([3]))
        j_sink.append_fields(np.array([5], np.uint64), np.array([3]))
        getattr(block, fn)(sink, raw, True)
        getattr(j_block, fn)(j_sink, raw, True)
        block.write_flush_marker(sink)
        j_block.write_flush_marker(j_sink)
        assert sink.getvalue() == j_sink.getvalue()
