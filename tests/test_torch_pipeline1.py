"""The port's round-1 encoder (device/match.py, device/encode.py's token
stages, device/pipeline.py) against the JAX package's jx/match.py,
jx/encode.py and jx/pipeline.py on the CPU, at small shapes: shards of
4,096 bytes, 4,096 bytes of context, batches of 2.  On the CPU the JAX
phase1 walks with parse_doubling and the port with parse_walk's plain
version (kernel B9's); the starts are equal.  Tolerance: exact (integers
and bytes)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import encode as j_enc
from flate_tpu.jx import match as j_match
from flate_tpu.jx import parse as j_parse
from flate_tpu.jx import pipeline as j_pl

from flate_tpu_torch import consts, errors
from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import encode as enc
from flate_tpu_torch.device import match
from flate_tpu_torch.device import pipeline as pl

from _torch_corpora import corpus
from _torch_round1_ref import assert_round1_member, decodes, jax_round1

S, CTX, BATCH = 4096, 4096, 2
WBITS = {Container.GZIP: 31, Container.ZLIB: 15, Container.RAW: -15}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain token walk is thousands of tiny tensor ops: one intra-op
    thread runs them faster, and keeps parallel test workers off each
    other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digits(n: int, seed: int = 0) -> bytes:
    """ASCII digits from a seed: few matches, an 8-symbol-ish alphabet, so
    the literal-only block wins."""
    rng = np.random.default_rng(seed)
    return bytes(48 + rng.integers(0, 10, n, dtype=np.uint8))


def _windows(kind: str, seed: int):
    """(2, CTX + S) windows of a corpus and their context lengths: row 0
    unprimed (ctx_len 0, zero context), row 1 primed with its previous
    CTX bytes."""
    data = corpus(kind, CTX + 2 * S, seed=seed) if kind != "digits" \
        else digits(CTX + 2 * S, seed)
    a = np.frombuffer(data, np.uint8)
    w = np.zeros((2, CTX + S), np.uint8)
    w[0, CTX:] = a[CTX:CTX + S]
    w[1] = a[S:2 * S + CTX]
    return w, np.array([0, CTX], np.int32)


WINDOW_KINDS = ["text", "mixed", "runs", "random", "digits"]


@pytest.mark.parametrize("K,nwords", [(8, 8), (64, 16), (2, 8), (192, 16)])
@pytest.mark.parametrize("kind", ["text", "mixed", "runs"])
def test_find_matches_device_equal(kind, K, nwords):
    w, cl = _windows(kind, seed=K)
    jl, jd = j_match.find_matches_device(
        jnp.asarray(w), jnp.asarray(cl), K=K, K3=min(8, K), ctx=CTX,
        nwords=nwords)
    tl, td = match.find_matches_device(
        torch.from_numpy(w), torch.from_numpy(cl), K=K, K3=min(8, K),
        ctx=CTX, nwords=nwords)
    assert tl.dtype == td.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if kind != "random":
        assert int((tl >= 3).sum()) > 100


def test_matcher_helpers_equal():
    w, _ = _windows("runs", seed=1)
    for nb in (3, 4):
        np.testing.assert_array_equal(
            match._hashes(torch.from_numpy(w), nb).numpy(),
            np.asarray(j_match._hashes(jnp.asarray(w), nb)))
    for nw in (2, 8, 16):
        np.testing.assert_array_equal(
            match._pack_words(torch.from_numpy(w), nw).numpy()
            .view(np.uint32),
            np.asarray(j_match._pack_words_u32(jnp.asarray(w), nw)))
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, (2, 500, 4), dtype=np.uint64)
    b = a.copy()
    b[:, :, 1] ^= (1 << rng.integers(0, 32, (2, 500))).astype(np.uint64)
    b[:, 100:, :] = a[:, 100:, :]
    a32, b32 = a.astype(np.uint32), b.astype(np.uint32)
    np.testing.assert_array_equal(
        match._match_len(torch.from_numpy(a32.view(np.int32)),
                         torch.from_numpy(b32.view(np.int32))).numpy(),
        np.asarray(j_match._match_len(jnp.asarray(a32), jnp.asarray(b32))))


def _jax_parse(w, cl, level):
    """The JAX phase1's matches, starts and take on window rows."""
    K, _nice, lazy, max_lazy = consts.LEVEL_PARAMS[level]
    ml, md = j_match.find_matches_device(
        jnp.asarray(w), jnp.asarray(cl), K=K, K3=min(8, K), ctx=CTX,
        nwords=16 if level >= 6 else 8)
    starts = j_parse.parse_doubling(ml, md, start=CTX, lazy=lazy,
                                    max_lazy=max_lazy)
    take, _ = j_parse.decide(ml, md, lazy, max_lazy)
    return [np.asarray(x)[:, CTX:] for x in (ml, md, starts, take)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("kind", ["text", "mixed"])
def test_token_stages_equal(kind, level):
    """compact_tokens, histograms and pack_tokens on the JAX package's
    parse, with the code tables of the JAX plan."""
    w, cl = _windows(kind, seed=level)
    ml, md, starts, take = _jax_parse(w, cl, level)
    win = w[:, CTX:]
    jtok = j_enc.compact_tokens(jnp.asarray(win), jnp.asarray(ml),
                                jnp.asarray(md), jnp.asarray(starts),
                                jnp.asarray(take))
    ttok = enc.compact_tokens(_t(win), _t(ml), _t(md), _t(starts), _t(take))
    assert set(ttok) == set(jtok)
    for k in jtok:
        np.testing.assert_array_equal(
            ttok[k].numpy().astype(np.int64),
            np.asarray(jtok[k]).astype(np.int64), err_msg=k)
    for a, b in zip(enc.histograms(ttok), j_enc.histograms(jtok)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    hll, hdd = (np.asarray(x) for x in j_enc.histograms(jtok))
    plans = j_pl.plan_shards(hll, hdd, [win[0], win[1]])
    llp, dp = pl.code_tables(plans, 2)
    jw, jb = j_enc.pack_tokens(jtok, jnp.asarray(llp), jnp.asarray(dp))
    tw, tb = enc.pack_tokens(ttok, _t(llp.astype(np.int64)),
                             _t(dp.astype(np.int64)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tw.shape == jw.shape and tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                  np.asarray(jw).astype(np.uint32))
    assert int(tb.max()) > 0


@pytest.mark.parametrize("level", [1, 4, 9])
@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_phase1_and_plans_equal(kind, level):
    """phase1's stats (histograms and token counts) and plan_shards' kinds
    and code lengths; then phase2 over the bucket and the fetched words."""
    w, cl = _windows(kind, seed=7)
    knobs = pl.level_knobs(level)
    jtok, jstats = j_pl.phase1(jnp.asarray(w), jnp.asarray(cl), ctx=CTX,
                               **knobs)
    ttok, tstats = pl.phase1(_t(w), _t(cl), ctx=CTX, **knobs)
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    views = [w[0, CTX:], w[1, CTX:]]
    jh = j_pl.unpack_stats(np.asarray(jstats))
    th = pl.unpack_stats(tstats.numpy())
    jplans = j_pl.plan_shards(jh[0], jh[1], views)
    tplans = pl.plan_shards(th[0], th[1], views)
    assert [p.kind for p in tplans] == [p.kind for p in jplans]
    for a, b in zip(tplans, jplans):
        for k in ("ll_lens", "d_lens"):
            if getattr(b, k) is None:
                assert getattr(a, k) is None
            else:
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    if kind == "random":
        assert [p.kind for p in tplans] == ["stored", "stored"]
    if kind == "digits":
        assert "literal" in [p.kind for p in tplans]
    llp, dp = pl.code_tables(tplans, 2)
    maxt = int(th[2].max())
    jw, jb = j_pl.phase2_bucketed(jtok, llp, dp, maxt)
    tw, tb = pl.phase2_bucketed(ttok, llp, dp, maxt)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jb_np = np.asarray(jb)
    np.testing.assert_array_equal(pl.fetch_words(tw, tb.numpy()),
                                  j_pl.fetch_words(jw, jb_np))
    got, got_bits = pl._WordFetcher()(tw, tb)
    np.testing.assert_array_equal(got, j_pl.fetch_words(jw, jb_np))
    np.testing.assert_array_equal(got_bits, jb_np)


def test_build_windows_equal():
    rng = np.random.default_rng(2)
    shards = rng.integers(0, 256, (3, S), dtype=np.uint8)
    ctx0 = rng.integers(0, 256, CTX, dtype=np.uint8)
    for ctx in (CTX, 1024):
        np.testing.assert_array_equal(
            pl.build_windows(_t(shards), _t(ctx0[:ctx]), ctx=ctx).numpy(),
            np.asarray(j_pl.build_windows(jnp.asarray(shards),
                                          jnp.asarray(ctx0[:ctx]), ctx=ctx)))


def _input(name: str) -> bytes:
    return {
        "text": lambda: corpus("text", 3 * S + 777, seed=1),
        "random": lambda: corpus("random", 2 * S + 100, seed=2),
        "digits": lambda: digits(2 * S + 50, seed=3),
        "short": lambda: corpus("mixed", 1000, seed=4),
        "empty": lambda: b"",
        "multiple": lambda: corpus("mixed", 4 * S, seed=5),
    }[name]()


INPUTS = ["text", "random", "digits", "short", "empty", "multiple"]
CONTAINERS = [Container.GZIP, Container.ZLIB, Container.RAW]


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("level", range(1, 10))
def test_compress_device_bytes_equal(level, name):
    """The round-1 member's bytes equal the JAX package's, every container
    at every level across the inputs, and decode with zlib."""
    data = _input(name)
    container = CONTAINERS[(level + INPUTS.index(name)) % 3]
    got = pl.compress_device(data, level=level, container=container,
                             shard_len=S, ctx=CTX, batch=BATCH,
                             device="cpu")
    want = jax_round1(data, container, level=level, shard_len=S, ctx=CTX,
                      batch=BATCH)
    assert got == want
    assert zlib.decompress(got, WBITS[container]) == data


def test_fixed_blocks_take_the_full_fixed_codes():
    """A shard whose cheapest block is fixed and holds literals 144-255:
    the JAX member does not decode (its fixed codes come from 286 of the
    288 fixed lengths); the port's decodes and is the repaired JAX
    member, of the same length.  On the same data the JAX and port stats
    and plans agree (test_phase1_and_plans_equal), so only the codes
    differ."""
    data = corpus("mixed", 8 * S, seed=5)[6 * S:7 * S]
    kw = dict(level=1, shard_len=S, ctx=CTX, batch=BATCH)
    got = pl.compress_device(data, container=Container.RAW, device="cpu",
                             **kw)
    assert not decodes(jax_round1(data, Container.RAW, **kw), data,
                       Container.RAW)
    assert not assert_round1_member(got, data, Container.RAW, **kw)
    a = np.frombuffer(data, np.uint8)
    assert ((a >= 144) & (a <= 255)).any()


def test_compress_device_batch_and_short_context():
    """The batch changes shapes, not bytes; a context shorter than the
    shard gives the JAX package's bytes too."""
    data = _input("text")
    one = pl.compress_device(data, level=6, shard_len=S, ctx=CTX, batch=1,
                             device="cpu")
    assert one == pl.compress_device(data, level=6, shard_len=S, ctx=CTX,
                                     batch=3, device="cpu")
    assert pl.compress_device(data, level=6, shard_len=S, ctx=1024, batch=2,
                              device="cpu") == \
        j_pl.compress_device(data, level=6, shard_len=S, ctx=1024, batch=2)


def test_compress_device_rejects():
    with pytest.raises(ValueError):
        pl.compress_device(b"abc", level=0, device="cpu")
    with pytest.raises(ValueError):
        pl.compress_device(b"abc", level=6, shard_len=S, ctx=2 * S,
                           device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is untestable")
    with pytest.raises(errors.DeviceUnavailable):
        pl.compress_device(b"abc", level=6)
