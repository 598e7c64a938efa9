"""Port field build (onehot, huff, header, encode2.build_fields) against the
JAX package on the outputs of real parses.  Tolerance: exact (u32 values
compared as uint32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import encode2 as j_encode2
from flate_tpu.jx import header as j_header
from flate_tpu.jx import huff as j_huff
from flate_tpu.jx import match2 as j_match2
from flate_tpu.jx import onehot as j_onehot
from flate_tpu.jx import parse as j_parse

from flate_tpu_torch.device import encode2, header, huff, onehot

from _torch_corpora import CTX, KINDS, S, tt, u32, windows


def _hists(seed, B=6, n=286):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 5000, (B, n)) * (rng.random((B, n)) < 0.4)
    h[0] = 0                        # no symbol
    h[1] = 0
    h[1, 7] = 3                     # one symbol
    h[2] = 0
    h[2, [3, n - 1]] = [1, 100000]  # two, skewed
    h[3] = rng.integers(1, 200000, n)   # every symbol, deep tree
    return h.astype(np.int32)


@pytest.mark.parametrize("n,max_bits", [(286, 15), (30, 15), (19, 7)])
def test_pm_lengths_and_codes_equal(n, max_bits):
    h = _hists(n, n=n)
    jl = np.asarray(j_huff.pm_lengths(jnp.asarray(h), max_bits))
    tl = huff.pm_lengths(tt(h), max_bits)
    np.testing.assert_array_equal(tl.numpy(), jl)
    jc = j_huff.canonical_codes_dev(jnp.asarray(jl), max_bits)
    tc = huff.canonical_codes_dev(tl, max_bits)
    np.testing.assert_array_equal(u32(tc), u32(jc))
    np.testing.assert_array_equal(
        huff.coded_size(tt(h), tl).numpy(),
        np.asarray(j_huff.coded_size(jnp.asarray(h), jnp.asarray(jl))))


def test_build_headers_equal():
    hl = _hists(1)
    hd = _hists(2, n=30)
    ll = np.asarray(j_huff.pm_lengths(jnp.asarray(hl), 15))
    dl = np.array(j_huff.pm_lengths(jnp.asarray(hd), 15))
    dl[dl.sum(axis=1) == 0, 0] = 1
    final = np.asarray([0, 1, 0, 1, 0, 0], np.int32)
    jv, jb, jt = j_header.build_headers(jnp.asarray(ll), jnp.asarray(dl),
                                        jnp.asarray(final))
    tv, tb, tt_ = header.build_headers(tt(ll), tt(dl), tt(final))
    np.testing.assert_array_equal(u32(tv), u32(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt))


def test_hist_and_lookup_equal():
    rng = np.random.default_rng(4)
    sym = rng.integers(0, 286, (3, 5000)).astype(np.int32)
    w = (rng.random((3, 5000)) < 0.7).astype(np.int32)
    np.testing.assert_array_equal(
        onehot.hist_onehot(tt(sym), tt(w), 286).numpy(),
        np.asarray(j_onehot.hist_onehot(jnp.asarray(sym), jnp.asarray(w),
                                        286)))
    tab = rng.integers(0, 2**32, (3, 286), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        u32(onehot.lookup_onehot(tt(tab.astype(np.int64)), tt(sym))),
        u32(j_onehot.lookup_onehot(jnp.asarray(tab), jnp.asarray(sym))))


def _parsed(win, ctx_len, valid, level_knobs=(12, 4)):
    """The JAX parse of a window batch: (tail, m_r, d_r, starts_r, take_r)."""
    K, nw = level_knobs
    ml, md = j_match2.find_matches_fused(
        jnp.asarray(win), jnp.asarray(ctx_len), jnp.asarray(valid), K=K,
        nw=nw, ctx=CTX, interpret=True)
    ml, md = j_parse.truncate_matches(ml, md, CTX, 1024)
    take, _ = j_parse.decide(ml, md, False, 0)
    starts = j_parse.parse_blocks(ml, md, start=CTX, lazy=False,
                                  max_lazy=0, blk=1024)
    return tuple(np.asarray(x)[:, CTX:] for x in
                 (win, ml, md, starts, take))


def _check_build(parts, valid, final):
    seg = encode2.seg_size(S, 1024)
    j = j_encode2.build_fields(*(jnp.asarray(p) for p in parts),
                               jnp.asarray(valid), jnp.asarray(final), S,
                               seg)
    t = encode2.build_fields(*(tt(p) for p in parts), tt(valid), tt(final),
                             S, seg)
    assert t[0].dtype == torch.int32            # vals: the packer's width
    np.testing.assert_array_equal(u32(t[0]), u32(j[0]))     # vals
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    return t[3].numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_build_fields_equal(kind):
    win = windows(kind, seed=13)
    ctx_len = np.asarray([CTX, 0], np.int32)
    valid = np.asarray([S, 1800], np.int32)
    final = np.asarray([0, 1], np.int32)
    _check_build(_parsed(win, ctx_len, valid), valid, final)


@pytest.mark.parametrize("n", [20, 47, 147, 301])
def test_build_fields_fixed_blocks_high_literals(n):
    """Tiny incompressible inputs pick fixed (or stored) blocks, and bytes
    >= 144 use the 9-bit fixed literal codes (the full 288-symbol
    assignment)."""
    rng = np.random.default_rng(1234 + n)
    win = np.zeros((2, CTX + S), np.uint8)
    win[0, CTX:CTX + n] = rng.integers(128, 256, n, dtype=np.uint8)
    win[1, CTX:CTX + n] = rng.integers(0, 256, n, dtype=np.uint8)
    valid = np.asarray([n, n], np.int32)
    kind = _check_build(_parsed(win, np.zeros(2, np.int32), valid, (4, 2)),
                        valid, np.asarray([1, 1], np.int32))
    if n == 20:
        assert kind[0] == encode2.KIND_FIX


def test_entropy_bits_close():
    """The float32 stored/coded estimate uses the same formula.  torch's
    and XLA's float32 log2 differ in the last bit on some inputs, so the
    tolerance is 2 ulp (rtol 2**-22); the decisions built on it are held
    exactly by test_build_fields_equal and the end-to-end tests."""
    h = _hists(9)
    np.testing.assert_allclose(
        encode2._entropy_bits(torch.from_numpy(h)).numpy(),
        np.asarray(j_encode2._entropy_bits(jnp.asarray(h))),
        rtol=2.0 ** -22, atol=0)
