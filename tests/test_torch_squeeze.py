"""Port squeeze (greedy_code_lengths, _entropy_lens, squeeze_parse) against
flate_tpu.jx.squeeze, fed with the JAX matcher's outputs on the four
corpora and with synthetic matches that force cost ties.

Tolerance: exact for every integer array.  The one float array,
_entropy_lens, to 1e-6, with the count of code lengths that round
differently asserted to be 0 on these corpora: a value within an ulp of
k + 0.5 could round the other way under another float32 log2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import match2 as j_match2
from flate_tpu.jx import parse as j_parse
from flate_tpu.jx import squeeze as j_squeeze

from flate_tpu_torch.device import squeeze

from _torch_corpora import CTX, KINDS, S, tt, windows

torch.set_num_threads(1)         # the DP is thousands of tiny ops


def _greedy(kind, blk, seed=7):
    """The shard-region inputs of the squeeze stage as the JAX package
    computes them at level-4 knobs: (window_tail, mlen, mdist, starts,
    take, valid_len), numpy."""
    win = windows(kind, seed=seed)
    ctx_len = np.asarray([CTX, 100], np.int32)
    valid = np.asarray([S, 2900], np.int32)
    ml, md = j_match2.find_matches_fused(
        jnp.asarray(win), jnp.asarray(ctx_len), jnp.asarray(valid), K=16,
        nw=4, ctx=CTX, interpret=True)
    ml, md = j_parse.truncate_matches(ml, md, CTX, blk)
    take, _ = j_parse.decide(ml, md, True, 4)
    starts = j_parse.parse_blocks(ml, md, start=CTX, lazy=True, max_lazy=4,
                                  blk=blk)
    return tuple(np.asarray(x)[:, CTX:] for x in
                 (win, ml, md, starts, take)) + (valid,)


@pytest.fixture(scope="module", params=KINDS)
def greedy(request):
    return {blk: _greedy(request.param, blk) for blk in (1024, 4096)}


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(xs):
    return tuple(tt(x) for x in xs)


@pytest.mark.parametrize("mode", ["default", "exact", "stride4"])
def test_greedy_code_lengths_equal(greedy, mode):
    kw = {"default": {}, "exact": {"exact": True},
          "stride4": {"stride": 4}}[mode]
    args = greedy[1024]
    jl, jd = j_squeeze.greedy_code_lengths(*_j(args), **kw)
    tl, td = squeeze.greedy_code_lengths(*_t(args), **kw)
    assert int((tl.numpy() != np.asarray(jl)).sum()) == 0
    assert int((td.numpy() != np.asarray(jd)).sum()) == 0
    assert tl.shape == (2, 286) and td.shape == (2, 30)
    assert int(tl.min()) >= 1 and int(tl.max()) <= 15


def test_entropy_lens_close(greedy):
    """float32 against XLA's: within 1e-6, and no entry rounds to another
    code length."""
    wt, ml, md, starts, take, valid = greedy[1024]
    rng = np.random.default_rng(0)
    hists = [np.bincount(wt[0], minlength=286)[None, :],
             rng.integers(0, 5000, (4, 286)),
             rng.integers(0, 3, (4, 30)) * rng.integers(1, 900, (4, 30)),
             np.zeros((1, 30), np.int64)]
    for h in hists:
        h = h.astype(np.int32)
        je = np.asarray(j_squeeze._entropy_lens(jnp.asarray(h)))
        te = squeeze._entropy_lens(tt(h)).numpy()
        assert te.dtype == np.float32
        np.testing.assert_allclose(te, je, rtol=0, atol=1e-6)
        assert int((np.round(te) != np.round(je)).sum()) == 0


def test_env_defaults_are_read_at_call_time(greedy, monkeypatch):
    args = greedy[1024]
    want = squeeze.greedy_code_lengths(*_t(args), stride=4)
    monkeypatch.setenv("FLATE_TPU_SQUEEZE_HIST_STRIDE", "4")
    got = squeeze.greedy_code_lengths(*_t(args))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not squeeze.grid_only_default()
    monkeypatch.setenv("FLATE_TPU_SQUEEZE_GRID", "1")
    assert squeeze.grid_only_default()


def _both_parse(wt, ml, md, ll, dd, blk, grid_only):
    jt, js, jsel = j_squeeze.squeeze_parse(
        *_j((wt, ml, md, ll, dd)), blk=blk, grid_only=grid_only)
    tk, ts, tsel = squeeze.squeeze_parse(
        *_t((wt, ml, md, ll, dd)), blk=blk, grid_only=grid_only)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jt))
    assert tsel.dtype == torch.int32 and ts.dtype == torch.bool
    return ts.numpy(), tsel.numpy()


@pytest.mark.parametrize("grid_only", [False, True])
@pytest.mark.parametrize("blk", [1024, 4096])
def test_squeeze_parse_equal(greedy, blk, grid_only):
    args = greedy[blk]
    ll, dd = j_squeeze.greedy_code_lengths(*_j(args))
    starts, sel = _both_parse(*args[:3], np.asarray(ll), np.asarray(dd), blk,
                              grid_only)
    # a parse: the chosen lengths tile every block exactly
    for row_s, row_l in zip(starts.reshape(-1, blk), sel.reshape(-1, blk)):
        i = tokens = 0
        while i < blk:
            assert row_s[i]
            i += int(row_l[i])
            tokens += 1
        assert i == blk and tokens == int(row_s.sum())


@pytest.mark.parametrize("grid_only", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_squeeze_parse_cost_ties(seed, grid_only):
    """Flat code lengths make many options cost the same: every literal
    costs `a` bits and every match `a * g` or so, so literal runs, the full
    length and grid lengths tie, and the first in the reference's order
    (literal, full length, grid ascending) must win.  Unseen symbols
    (length 0 -> 15) and lengths on and off the grid are mixed in."""
    rng = np.random.default_rng(seed)
    B, blk = 2, 1024
    n = 2 * blk
    wt = rng.integers(0, 4, (B, n), dtype=np.uint8)
    grid = np.asarray(squeeze.GRID)
    ml = np.where(rng.random((B, n)) < 0.5,
                  rng.choice(grid, (B, n)), rng.integers(0, 259, (B, n)))
    ml = np.where(ml < 3, 0, ml)
    room = blk - (np.arange(n) % blk)
    ml = np.minimum(ml, room[None, :])
    ml = np.where(ml < 3, 0, ml).astype(np.int32)
    md = np.where(ml > 0, rng.choice([1, 2, 5, 9], (B, n)), 0
                  ).astype(np.int32)
    ll = np.full((B, 286), 2 + seed, np.int32)
    ll[:, 257:] = 4 + 2 * seed                 # len code = two literals
    ll[0, 3] = 0                               # an unseen byte
    dd = np.zeros((B, 30), np.int32)           # distance codes cost 0 bits
    dd[1] = 2
    starts, sel = _both_parse(wt, ml, md, ll, dd, blk, grid_only)
    assert (sel >= 3).any() and (sel == 1).any()


def test_squeeze_parse_rejects_a_ragged_region():
    z = torch.zeros((1, 1000), dtype=torch.int32)
    with pytest.raises(ValueError):
        squeeze.squeeze_parse(z.to(torch.uint8), z, z,
                              torch.ones((1, 286), dtype=torch.int32),
                              torch.ones((1, 30), dtype=torch.int32),
                              blk=512)


@pytest.mark.parametrize("length", squeeze.GRID + (7, 9, 10, 11, 130, 257))
def test_length_code_py_equal(length):
    assert squeeze._length_code_py(length) == \
        j_squeeze._length_code_py(length)


def test_match_bits_equal(greedy):
    wt, ml, md, starts, take, valid = greedy[1024]
    ll, dd = j_squeeze.greedy_code_lengths(*_j(greedy[1024]))
    jb = j_squeeze._match_bits(jnp.asarray(ml), jnp.asarray(md), ll, dd)
    tb = squeeze._match_bits(tt(ml), tt(md), tt(ll), tt(dd))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert squeeze.GRID == j_squeeze.GRID and squeeze.WIN == j_squeeze.WIN
    assert squeeze.BIG == int(j_squeeze.BIG)
