"""The squeeze's rounded code lengths (squeeze._entropy_code_lens) against
the JAX pipeline's, which runs flate_tpu.jx.squeeze._entropy_lens under
jax.jit (pipeline2._squeeze_stage and encode_batch).  There XLA computes
log2 p as log(p) * f32(1 / ln 2), and the rounded length differs from the
one of a correctly rounded log2 on 204 of the count pairs below.

Tolerance: exact, every length and every threshold.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import squeeze as j_squeeze

from flate_tpu_torch.device import squeeze

from chip_smoke import length_step_pairs

_jit_lens = jax.jit(lambda h: jnp.round(j_squeeze._entropy_lens(h)))
_jit_greedy = jax.jit(j_squeeze.greedy_code_lengths,
                      static_argnames=("exact", "stride"))
CHUNK = 1 << 20
# (count, total, the jitted JAX length, the correctly rounded log2's)
FLIPS = ((5, 22_724, 12, 13), (3_694, 16_395, 3, 2), (563, 19_990, 6, 5))


def _rows(h, t, width):
    """(N, width) int32 histograms: h, then total - h, then zeros."""
    rows = np.zeros((len(h), width), np.int32)
    rows[:, 0], rows[:, 1] = h, t - h
    return rows


@functools.lru_cache(maxsize=None)
def _pairs():
    """The pairs, the jitted JAX lengths of their counts at the distance
    histogram's width (30), and the pairs where the correctly rounded
    log2 (the port's _entropy_lens, rounded) gives another length."""
    h, t = length_step_pairs()
    want = np.concatenate([
        np.asarray(_jit_lens(jnp.asarray(_rows(h[i:i + CHUNK],
                                               t[i:i + CHUNK], 30))))[:, 0]
        for i in range(0, len(h), CHUNK)]).astype(np.int64)
    eager = torch.round(squeeze._entropy_lens(
        torch.from_numpy(_rows(h, t, 2))))[:, 0].numpy()
    return h, t, want, np.nonzero(eager != want)[0]


def test_pairs_span_a_128k_shard():
    h, t, _, _ = _pairs()
    assert len(h) == 8_638_909
    assert int(t.max()) == 131_073 and int(h.min()) == 1


def test_code_lens_equal_jitted_jax_on_every_pair():
    """Every pair at the distance histogram's width: the port's lengths
    are the jitted JAX lengths, and the correctly rounded log2's differ
    on 204 of them (totals 16,395-130,947)."""
    h, t, want, flips = _pairs()
    got = np.concatenate([
        squeeze._entropy_code_lens(torch.from_numpy(
            _rows(h[i:i + CHUNK], t[i:i + CHUNK], 30)))[:, 0].numpy()
        for i in range(0, len(h), CHUNK)])
    assert int((got != want).sum()) == 0
    assert len(flips) == 204
    assert (int(t[flips].min()), int(t[flips].max())) == (16_395, 130_947)


def test_code_lens_equal_at_the_literal_width():
    """The flip pairs and every 17th pair at the literal/length
    histogram's width (286)."""
    h, t, want, flips = _pairs()
    pick = np.concatenate([flips, np.arange(0, len(h), 17)])
    wide = _rows(h[pick], t[pick], 286)
    jl = np.asarray(_jit_lens(jnp.asarray(wide)))
    tl = squeeze._entropy_code_lens(torch.from_numpy(wide)).numpy()
    np.testing.assert_array_equal(tl, jl)
    assert (tl[:, 0] == want[pick]).all()


def test_steps_are_the_jitted_jax_steps():
    """The 14 steps derived again: over every float32 p within 3,000 ulps
    of 2^-(k + 0.15) (rows [p, 1 - p], which sum to 1 in float32), the
    jitted JAX length never rises as p rises, and the last p with length
    k + 1 is the port's P_k.  Over the pairs, P_k lies between the largest
    realizable p with length k + 1 and the smallest with length k."""
    h, t, want, _ = _pairs()
    p_real = h.astype(np.float32) / t.astype(np.float32)
    for k, bits in enumerate(squeeze._LEN_STEPS, start=1):
        grid = np.arange(bits - 3000, bits + 3000, dtype=np.uint32)
        p = grid.view(np.float32)
        q = np.float32(1) - p
        assert ((p + q) == 1).all()
        lens = np.asarray(_jit_lens(jnp.asarray(np.stack([p, q], 1))))[:, 0]
        assert int((np.diff(lens) > 0).sum()) == 0
        assert int(grid[lens >= k + 1].max()) == bits
        step = np.uint32(bits).view(np.float32)
        assert p_real[want >= k + 1].max() <= step < p_real[want <= k].min()
    got = squeeze._len_steps(torch.device("cpu")).numpy().view(np.uint32)
    assert tuple(int(b) for b in got[::-1]) == squeeze._LEN_STEPS


def _literal_shards(stride):
    """One literal-only shard per FLIPS pair: symbol 0x41 `count` times
    among total - 1 literals (every other byte value in turn), every
    stride-th position sampled.  (window_tail, mlen, mdist, starts, take,
    valid_len) numpy."""
    S = 32_768 * stride
    wt = np.zeros((len(FLIPS), S), np.uint8)
    valid = np.zeros(len(FLIPS), np.int32)
    others = np.asarray([b for b in range(256) if b != 0x41], np.uint8)
    for r, (count, total, _, _) in enumerate(FLIPS):
        n = total - 1
        lits = np.resize(others, n)
        lits[np.linspace(0, n - 1, count).astype(np.int64)] = 0x41
        wt[r, :n * stride:stride] = lits
        valid[r] = (n - 1) * stride + 1
    zeros = np.zeros((len(FLIPS), S), np.int32)
    return (wt, zeros, zeros, np.ones((len(FLIPS), S), bool),
            np.zeros((len(FLIPS), S), bool), valid)


@pytest.mark.parametrize("stride", [1, 4])
def test_greedy_code_lengths_equal_jitted_on_flip_pairs(stride):
    """greedy_code_lengths under jax.jit against the port on literal-only
    shards that hold the flip pairs (count, total): the jitted JAX
    length, which the correctly rounded log2 misses."""
    args = _literal_shards(stride)
    jl, jd = _jit_greedy(*(jnp.asarray(a) for a in args), stride=stride)
    tl, td = squeeze.greedy_code_lengths(
        *(torch.from_numpy(a) for a in args), stride=stride)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for r, (_, _, jax_len, eager_len) in enumerate(FLIPS):
        assert int(tl[r, 0x41]) == jax_len != eager_len
