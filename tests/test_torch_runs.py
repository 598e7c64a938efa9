"""Port runs.small_dist_runs / extend_chains / extend_chains2 against the
JAX Pallas kernels
(interpret mode) on seeded corpora.  Tolerance: exact, element for
element."""

import jax.numpy as jnp
import numpy as np
import pytest

from flate_tpu.jx import match2 as j_match2
from flate_tpu.jx import runs as j_runs

from flate_tpu_torch.device import runs

from _torch_corpora import (CTX, KINDS, S, small_run_edge_rows, tt,
                            windows)


def _bounds(ctx_len, valid):
    ctx_len = np.asarray(ctx_len, np.int32)
    valid = np.asarray(valid, np.int32)
    return CTX + valid, CTX - ctx_len


# (ctx_len, valid_len) per row: full rows, and a tail shard with a
# partial context
BOUNDS = [([CTX, CTX], [S, S]), ([0, 300], [S, 1234])]


@pytest.mark.parametrize("bounds", BOUNDS, ids=["full", "tail"])
@pytest.mark.parametrize("kind", KINDS)
def test_small_dist_runs_equal(kind, bounds):
    win = windows(kind, seed=11)
    limit, min_src = _bounds(*bounds)
    jl, jd = j_runs.small_dist_runs(jnp.asarray(win), jnp.asarray(limit),
                                    jnp.asarray(min_src), interpret=True)
    tl, td = runs.small_dist_runs(tt(win), tt(limit), tt(min_src))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("W", [3 * 8192 + 100, 1000])
def test_small_dist_runs_edges_equal(W):
    """Runs of 257, 258 and 259 bytes and of periods 2-8 across every
    4,096-position tile end (the JAX kernel's 8,192 ends among them), a
    limit inside a run and inside the 257-byte halo, min_src inside a tile,
    d = 8 at tile starts, limit <= min_src; W not a multiple of either
    tile, and W below both (tests/_torch_corpora.py small_run_edge_rows)."""
    win, limit, min_src = small_run_edge_rows(W, seed=W)
    jl, jd = j_runs.small_dist_runs(jnp.asarray(win), jnp.asarray(limit),
                                    jnp.asarray(min_src), interpret=True)
    tl, td = runs.small_dist_runs(tt(win), tt(limit), tt(min_src))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (tl.numpy() == 258).any() and not tl.numpy()[3].any()


@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("kind", ["text", "runs", "mixed"])
def test_extend_chains_equal(kind, cap):
    """Inputs are real capped matches: the JAX matcher's candidate pass
    with nw = cap/4 carry words, merged with the small-distance runs."""
    win = windows(kind, seed=5)
    limit, min_src = _bounds([CTX, 200], [S, 3000])
    ld = np.asarray(j_match2._candidate_pass(
        jnp.asarray(win), jnp.asarray(min_src), jnp.asarray(limit),
        K=8, nw=cap // 4, hash_bytes=4, max_dist=32768, interpret=True))
    mlen = (ld >> 16).astype(np.int32)
    mdist = (ld & 0xFFFF).astype(np.int32)
    assert (mlen == cap).any()
    jo = j_runs.extend_chains(jnp.asarray(mlen), jnp.asarray(mdist),
                              jnp.asarray(limit), cap=cap, interpret=True)
    to = runs.extend_chains(tt(mlen), tt(mdist), tt(limit), cap)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_extend_chains_long_chains_at_the_edge():
    """Synthetic chains that run past W and the limit."""
    rng = np.random.default_rng(9)
    B, W = 2, CTX + S
    mlen = np.where(rng.random((B, W)) < 0.7, 8, rng.integers(0, 9, (B, W)))
    mlen = mlen.astype(np.int32)
    mdist = np.where(rng.random((B, W)) < 0.8, 5, rng.integers(0, 7, (B, W)))
    mdist = mdist.astype(np.int32)
    limit = np.asarray([W, W - 77], np.int32)
    jo = j_runs.extend_chains(jnp.asarray(mlen), jnp.asarray(mdist),
                              jnp.asarray(limit), cap=8, interpret=True)
    to = runs.extend_chains(tt(mlen), tt(mdist), tt(limit), 8)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _both_extend2(l1, d1, l2, d2, limit, cap):
    jl, jd = j_runs.extend_chains2(*(jnp.asarray(x) for x in
                                     (l1, d1, l2, d2, limit)), cap=cap,
                                   interpret=True)
    tl, td = runs.extend_chains2(*(tt(x) for x in (l1, d1, l2, d2, limit)),
                                 cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    return tl.numpy()


@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("kind", ["text", "runs", "mixed"])
def test_extend_chains2_equal(kind, cap):
    """Inputs are the JAX matcher's real top-2 outputs, fingerprint-ranked
    with ne = cap/4 exact words."""
    win = windows(kind, seed=5)
    limit, min_src = _bounds([CTX, 200], [S, 3000])
    ld, ld2 = (np.asarray(x) for x in j_match2._candidate_pass(
        jnp.asarray(win), jnp.asarray(min_src), jnp.asarray(limit),
        K=8, nw=cap // 2, hash_bytes=4, max_dist=32768, interpret=True,
        fp=cap // 4, top2=True))
    l1, d1 = (ld >> 16).astype(np.int32), (ld & 0xFFFF).astype(np.int32)
    l2, d2 = (ld2 >> 16).astype(np.int32), (ld2 & 0xFFFF).astype(np.int32)
    assert (l1 == cap).any() and (l2 == cap).any()
    _both_extend2(l1, d1, l2, d2, limit, cap)


@pytest.mark.parametrize("cap", [8, 16])
def test_extend_chains2_alternating_candidates(cap):
    """A chain whose distance sits in the first candidate at one link and in
    the second at the next, across the 8,192-position tile edge; the other
    candidate holds a decoy distance."""
    B, W = 2, 3 * 8192 + 100
    l1 = np.zeros((B, W), np.int32)
    d1, l2, d2 = l1.copy(), l1.copy(), l1.copy()
    starts = {0: 8192 - 5 * cap, 1: 2 * 8192 - 3 * cap + 1}
    for b, p0 in starts.items():
        for k in range(12):
            p = p0 + k * cap
            first = (k + b) % 2 == 0
            (l1 if first else l2)[b, p] = cap
            (d1 if first else d2)[b, p] = 77
            (l2 if first else l1)[b, p] = cap if k % 3 else 5
            (d2 if first else d1)[b, p] = 1234 + k
        p_end = p0 + 12 * cap
        l2[b, p_end], d2[b, p_end] = 3, 77          # the unsaturated tail
    limit = np.asarray([W, W - 50], np.int32)
    out = _both_extend2(l1, d1, l2, d2, limit, cap)
    for b, p0 in starts.items():
        assert out[b, p0] == min(12 * cap + 3, 258)


def test_extend_chains2_random_and_tail_limits():
    """Dense synthetic candidates (many saturated links, few distances, so
    chains are long and switch candidates often) with limits that cut the
    tail, and rows that end inside a chain."""
    rng = np.random.default_rng(3)
    B, W = 3, CTX + S + 37

    def cand():
        l = np.where(rng.random((B, W)) < 0.75, 8, rng.integers(0, 9, (B, W)))
        d = np.where(rng.random((B, W)) < 0.6, rng.integers(4, 7, (B, W)),
                     rng.integers(0, 40, (B, W)))
        return l.astype(np.int32), d.astype(np.int32)
    l1, d1 = cand()
    l2, d2 = cand()
    limit = np.asarray([W, W - 300, 40], np.int32)
    _both_extend2(l1, d1, l2, d2, limit, 8)
