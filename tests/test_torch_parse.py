"""Port parse (truncate_matches, decide, _runs_of_ones, parse_blocks,
parse_walk, parse_doubling) against the JAX package on matches of real
corpora, and the row walk against a serial walk written out in numpy.
Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import match2 as j_match2
from flate_tpu.jx import parse as j_parse

from flate_tpu_torch.device import parse

from _torch_corpora import CTX, KINDS, S, parse_edge_rows, tt, windows


def _matches(kind, seed=7):
    """Real (mlen, mdist) from the JAX matcher at level-3 knobs."""
    win = windows(kind, seed=seed)
    ctx_len = np.asarray([CTX, 100], np.int32)
    valid = np.asarray([S, 2900], np.int32)
    ml, md = j_match2.find_matches_fused(
        jnp.asarray(win), jnp.asarray(ctx_len), jnp.asarray(valid), K=12,
        nw=4, ctx=CTX, interpret=True)
    return np.asarray(ml), np.asarray(md)


@pytest.fixture(scope="module", params=KINDS)
def matches(request):
    return _matches(request.param)


@pytest.mark.parametrize("blk", [1024, 4096])
def test_truncate_matches_equal(matches, blk):
    ml, md = matches
    jl, jd = j_parse.truncate_matches(jnp.asarray(ml), jnp.asarray(md), CTX,
                                      blk)
    tl, td = parse.truncate_matches(tt(ml), tt(md), CTX, blk)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("lazy,max_lazy", [(False, 0), (True, 4),
                                           (True, 32)])
def test_decide_equal(matches, lazy, max_lazy):
    ml, md = matches
    jt, js = j_parse.decide(jnp.asarray(ml), jnp.asarray(md), lazy, max_lazy)
    tk, ts = parse.decide(tt(ml), tt(md), lazy, max_lazy)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_runs_of_ones_equal():
    rng = np.random.default_rng(0)
    x = rng.random((8, 1024)) < 0.8
    x[3] = True
    np.testing.assert_array_equal(
        parse._runs_of_ones(tt(x), 1024).numpy(),
        np.asarray(j_parse._runs_of_ones(jnp.asarray(x), 1024)))


@pytest.mark.parametrize("lazy,max_lazy,blk", [(False, 0, 1024),
                                               (True, 32, 1024),
                                               (True, 258, 4096)])
def test_parse_blocks_equal(matches, lazy, max_lazy, blk):
    ml, md = matches
    ml, md = j_parse.truncate_matches(jnp.asarray(ml), jnp.asarray(md), CTX,
                                      blk)
    ml, md = np.asarray(ml), np.asarray(md)
    js = j_parse.parse_blocks(jnp.asarray(ml), jnp.asarray(md), start=CTX,
                              lazy=lazy, max_lazy=max_lazy, blk=blk)
    ts = parse.parse_blocks(tt(ml), tt(md), start=CTX, lazy=lazy,
                            max_lazy=max_lazy, blk=blk)
    assert ts.numpy().dtype == np.asarray(js).dtype == bool
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _serial_walk(step: np.ndarray) -> np.ndarray:
    """What kernel B9 computes, row by row: from 0, mark i, add step[i]."""
    out = np.zeros(step.shape, bool)
    for r, row in enumerate(step):
        i = 0
        while i < row.size:
            out[r, i] = True
            i += max(int(row[i]), 1)
    return out


PARSE_MODES = [(False, 0), (True, 4), (True, 32), (True, 258)]


@pytest.mark.parametrize("lazy,max_lazy", PARSE_MODES)
def test_parse_walk_equal(matches, lazy, max_lazy):
    ml, md = matches
    js = j_parse.parse_walk(jnp.asarray(ml), jnp.asarray(md), start=CTX,
                            lazy=lazy, max_lazy=max_lazy, interpret=True)
    ts = parse.parse_walk(tt(ml), tt(md), start=CTX, lazy=lazy,
                          max_lazy=max_lazy)
    assert ts.dtype == torch.bool
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("start", [0, CTX])
@pytest.mark.parametrize("lazy,max_lazy", PARSE_MODES)
def test_parse_doubling_equal(matches, lazy, max_lazy, start):
    ml, md = matches
    js = j_parse.parse_doubling(jnp.asarray(ml), jnp.asarray(md), start,
                                lazy=lazy, max_lazy=max_lazy)
    ts = parse.parse_doubling(tt(ml), tt(md), start, lazy=lazy,
                              max_lazy=max_lazy)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if start == CTX:
        # same contract as the serial walk
        tw = parse.parse_walk(tt(ml), tt(md), start=CTX, lazy=lazy,
                              max_lazy=max_lazy)
        np.testing.assert_array_equal(ts.numpy(), tw.numpy())


@pytest.mark.parametrize("blk", [256, 1024, 4096])
@pytest.mark.parametrize("lazy,max_lazy", PARSE_MODES)
def test_row_walk_equals_parse_blocks(matches, lazy, max_lazy, blk):
    """parse_blocks' mask over a row is a serial walk of the step array
    restarted at every block: what the row-walk kernel is handed.  The
    step is decided on whole rows (the lazy rule reads mlen[p+1] across a
    block's end) and only then cut into blocks."""
    ml, md = matches
    tl, td = parse.truncate_matches(tt(ml), tt(md), CTX, blk)
    _, step = parse.decide(tl, td, lazy, max_lazy)
    sb = step[:, CTX:].to(torch.int32).reshape(-1, blk)
    want = _serial_walk(sb.numpy())
    np.testing.assert_array_equal(parse._parse_walk(sb).numpy(), want)
    got = parse.parse_blocks(tl, td, start=CTX, lazy=lazy,
                             max_lazy=max_lazy, blk=blk)
    assert not got[:, :CTX].any()
    np.testing.assert_array_equal(got[:, CTX:].numpy(),
                                  want.reshape(ml.shape[0], S))


def test_parse_walk_steps_past_the_row():
    """Steps that overshoot the row's end, literal runs to the end, and a
    non-positive step (taken as 1)."""
    step = np.asarray([[3, 1, 1, 9, 1, 1, 1, 1],
                       [1, 1, 1, 1, 1, 1, 1, 1],
                       [2, 5, 0, 1, 4, 1, 1, 1],
                       [8, 1, 1, 1, 1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(parse._parse_walk(tt(step)).numpy(),
                                  _serial_walk(step))


@pytest.mark.parametrize("n", [1024, 2048])
def test_parse_walk_edge_rows_equal_jax(n):
    """Rows with a step of n, of 70,000, of 100,000 and of 8,195 on the
    chain (tests/_torch_corpora.py parse_edge_rows), against the JAX
    kernel in interpret mode: it takes only steps >= 1 whose sums stay in
    int32, and rows of a multiple of 1024."""
    step = parse_edge_rows(7, n, seed=n, jax_safe=True)
    want = np.asarray(j_parse._parse_walk_pallas(jnp.asarray(step), True))
    np.testing.assert_array_equal(parse._parse_walk(tt(step)).numpy(), want)
    np.testing.assert_array_equal(want, _serial_walk(step))


@pytest.mark.parametrize("n", [1000, 1024])
def test_parse_walk_edge_rows_serial(n):
    """Steps of 0 and -5 (taken as 1), n, 70,000, 2^31 - 1 and 8,195 on
    the chain, and a row length that is no multiple of 16, against the
    serial walk in numpy."""
    step = parse_edge_rows(7, n, seed=n)
    np.testing.assert_array_equal(parse._parse_walk(tt(step)).numpy(),
                                  _serial_walk(step))
