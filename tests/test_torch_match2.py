"""Port match2 against the JAX fused matcher (Pallas, interpret mode):
_prep contents (the port's B1 writes keys and fingerprints; the exact
carry words the JAX prep writes are built from the window by
_window_words), the candidate pass and find_matches_fused for the (K, nw,
K3) of the LEVEL_KERNEL rows.  Tolerance: exact (u32 compared as
uint32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import match2 as j_match2
from flate_tpu.jx import pipeline2 as j_pipeline2

from flate_tpu_torch.device import match2

from _torch_corpora import CTX, KINDS, S, tt, u32, windows


def _jax_words(win, ne, nf, hash_bytes):
    """The JAX prep's (key, words (B, ne+nf, Wp)): its words tiled
    (T, ne+nf, 8, 1024) laid out as the port's (ne+nf, Wp)."""
    B = win.shape[0]
    jkey, jwords = j_match2._prep(jnp.asarray(win), ne, nf, hash_bytes,
                                  interpret=True)
    jwords = np.asarray(jwords)
    T = jwords.shape[1]
    return jkey, jwords.transpose(0, 2, 1, 3, 4).reshape(B, ne + nf,
                                                         T * 8 * 1024)


def _all_words(win, ne, hash_bytes):
    """The exact words of every position [0, Wp) built from the window."""
    B, W = win.shape
    Wp = -(-W // match2.TILE) * match2.TILE
    pos = torch.arange(Wp).expand(B, Wp)
    return match2._window_words(win, pos, ne, hash_bytes)


@pytest.mark.parametrize("nw,hash_bytes", [(2, 4), (4, 4), (16, 4), (1, 3)])
def test_prep_contents_equal(nw, hash_bytes):
    """Keys, and carry words compared by content: B1 writes none, the
    window gives them (the TPU tiles its words as (T, nw, 8, 1024))."""
    win = windows("mixed", seed=2)
    jkey, jwords = _jax_words(win, nw, 0, hash_bytes)
    key, words = match2._prep(tt(win), nw, hash_bytes)
    assert key.dtype == torch.int32           # stored as u32 key ^ 2^31
    np.testing.assert_array_equal(u32(match2.key_u32(key)), u32(jkey))
    assert words.shape == (win.shape[0], 0, key.shape[1])
    np.testing.assert_array_equal(u32(_all_words(tt(win), nw, hash_bytes)),
                                  u32(jwords))


@pytest.mark.parametrize("K,nw,hash_bytes,max_dist",
                         [(4, 2, 4, 32768), (12, 4, 4, 32768),
                          (12, 1, 3, 4096), (16, 1, 3, 4096),
                          (8, 3, 4, 32768)])
@pytest.mark.parametrize("kind", ["text", "runs"])
def test_candidate_pass_equal(kind, K, nw, hash_bytes, max_dist):
    """Sort + matcher + unsort, including the 3-byte K3 passes of rows
    8 and 9 (K3 = 12, 16) and 3 exact words, a count no level uses."""
    win = windows(kind, seed=4)
    min_src = np.asarray([0, CTX - 100], np.int32)
    limit = np.asarray([CTX + S, CTX + 2500], np.int32)
    jld = j_match2._candidate_pass(
        jnp.asarray(win), jnp.asarray(min_src), jnp.asarray(limit), K=K,
        nw=nw, hash_bytes=hash_bytes, max_dist=max_dist, interpret=True)
    ld = match2._candidate_pass(tt(win), tt(min_src), tt(limit), K=K, nw=nw,
                                hash_bytes=hash_bytes, max_dist=max_dist)
    np.testing.assert_array_equal(u32(ld), u32(jld))


# Rows 8 and 9 (K = 96 / 160 with 16 words) take minutes each to trace in
# interpret mode; their K3 passes are held above and their main pass shares
# the code path of row 7.
ROWS = [1, 2, 3, 4, 5, 6, 7]


@pytest.mark.parametrize("level", ROWS)
def test_find_matches_fused_rows_equal(level):
    K, nw, _, _, K3, _, _ = j_pipeline2.LEVEL_KERNEL[level]
    win = np.concatenate([windows("text", 1, seed=level),
                          windows("mixed", 1, seed=level)])
    ctx_len = np.asarray([CTX, 300], np.int32)
    valid = np.asarray([S, 3333], np.int32)
    jl, jd = j_match2.find_matches_fused(
        jnp.asarray(win), jnp.asarray(ctx_len), jnp.asarray(valid), K=K,
        nw=nw, ctx=CTX, K3=K3, interpret=True)
    tl, td = match2.find_matches_fused(tt(win), tt(ctx_len), tt(valid), K=K,
                                       nw=nw, ctx=CTX, K3=K3)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [1, 3])
def test_find_matches_fused_corpora_equal(level, kind):
    """The slice's levels on every corpus, with an unprimed row."""
    K, nw, _, _, K3, _, _ = j_pipeline2.LEVEL_KERNEL[level]
    win = windows(kind, seed=21)
    ctx_len = np.asarray([0, CTX], np.int32)
    valid = np.asarray([S, S - 1], np.int32)
    jl, jd = j_match2.find_matches_fused(
        jnp.asarray(win), jnp.asarray(ctx_len), jnp.asarray(valid), K=K,
        nw=nw, ctx=CTX, K3=K3, interpret=True)
    tl, td = match2.find_matches_fused(tt(win), tt(ctx_len), tt(valid), K=K,
                                       nw=nw, ctx=CTX, K3=K3)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("nw,fp", [(8, True), (8, 4), (16, True), (4, 1)])
def test_prep_fingerprints_equal(nw, fp):
    """ne exact words (from the window), then nf FNV fingerprint words
    (u32 wraparound, from B1)."""
    win = windows("mixed", seed=6)
    ne, nf = match2._split_words(nw, fp)
    assert (ne, nf) == j_match2._split_words(nw, fp)
    assert nf > 0
    jkey, jwords = _jax_words(win, ne, nf, 4)
    key, words = match2._prep(tt(win), ne, 4, nf)
    np.testing.assert_array_equal(u32(match2.key_u32(key)), u32(jkey))
    np.testing.assert_array_equal(u32(words), u32(jwords[:, ne:]))
    np.testing.assert_array_equal(u32(_all_words(tt(win), ne, 4)),
                                  u32(jwords[:, :ne]))


def test_split_words_rejects_a_bad_reach():
    with pytest.raises(ValueError):
        match2._split_words(12, True)        # 12 is not 2 * 2^k


@pytest.mark.parametrize("fp", [False, True, 4])
@pytest.mark.parametrize("kind", ["text", "runs", "mixed"])
def test_candidate_pass_top2_equal(kind, fp):
    """Best and runner-up, both outputs, exact-only and fingerprint-ranked
    (the runner-up depends on the order of the candidates)."""
    win = windows(kind, seed=4)
    min_src = np.asarray([0, CTX - 100], np.int32)
    limit = np.asarray([CTX + S, CTX + 2500], np.int32)
    jld, jld2 = j_match2._candidate_pass(
        jnp.asarray(win), jnp.asarray(min_src), jnp.asarray(limit), K=8,
        nw=8, hash_bytes=4, max_dist=32768, interpret=True, fp=fp,
        top2=True)
    ld, ld2 = match2._candidate_pass(tt(win), tt(min_src), tt(limit), K=8,
                                     nw=8, hash_bytes=4, max_dist=32768,
                                     fp=fp, top2=True)
    np.testing.assert_array_equal(u32(ld), u32(jld))
    np.testing.assert_array_equal(u32(ld2), u32(jld2))
    assert (u32(ld2) != 0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_find_matches_fused_fp_equal(kind):
    """fp=True at K=8, nw=8 (the JAX package's own fp case): fingerprint
    ranking, top-2 extension with cap 8, then the common tail."""
    win = windows(kind, seed=13)
    ctx_len = np.asarray([CTX, 300], np.int32)
    valid = np.asarray([S, 3333], np.int32)
    jl, jd = j_match2.find_matches_fused(
        jnp.asarray(win), jnp.asarray(ctx_len), jnp.asarray(valid), K=8,
        nw=8, ctx=CTX, fp=True, interpret=True)
    tl, td = match2.find_matches_fused(tt(win), tt(ctx_len), tt(valid), K=8,
                                       nw=8, ctx=CTX, fp=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # every match is a valid back-reference
    ml, md = tl.numpy(), td.numpy()
    for b, p in zip(*np.nonzero(ml >= 3)):
        l, d = int(ml[b, p]), int(md[b, p])
        assert 1 <= d <= p
        assert all(win[b, p + i] == win[b, p + i - d] for i in range(l))


@pytest.mark.parametrize("ne,nf", [(2, 0), (8, 0), (2, 2)])
def test_run_matcher_plain_counts_the_scan(ne, nf):
    """stats= counts what a serial scan needs on the data: the candidates
    within K before the scan's end (another bucket, past max_dist, below
    min_src) in rows with 3 bytes before their limit, then for a valid
    candidate one compare per exact word up to the first that differs and,
    past a full exact run, per fingerprint word likewise.  The outputs do
    not change."""
    K, max_dist = 8, 32768
    win = tt(windows("mixed", seed=5))
    W = win.shape[1]
    min_src = np.asarray([0, CTX - 100], np.int32)
    limit = np.asarray([CTX + S, CTX + 2500], np.int32)
    key, fps = match2._prep(win, ne, 4, nf)
    skey, order = torch.sort(key, dim=1)
    args = (skey, order, win, fps, tt(min_src), tt(limit), W, K, max_dist,
            ne)
    stats = {}
    counted = match2._run_matcher_plain(*args, stats=stats)
    assert torch.equal(counted, match2._run_matcher_plain(*args))
    sk = match2.key_u32(skey).numpy()
    wd = np.concatenate([_all_words(win, ne, 4).numpy(),
                         u32(fps).astype(np.int64)], axis=1)
    visits = compares = 0
    for b in range(sk.shape[0]):
        live = sk[b][sk[b] != match2.SENTINEL]
        pos = live & match2.POS_MASK
        bucket = live >> match2.POS_BITS
        for i in range(len(live)):
            if min(258, limit[b] - int(pos[i])) < 3:
                continue
            for k in range(1, min(K, i) + 1):
                t, c = int(pos[i]), int(pos[i - k])
                if bucket[i - k] != bucket[i] or t - c > max_dist \
                        or c < min_src[b]:
                    break
                visits += 1
                if not (1 <= t - c and c < limit[b]):
                    continue
                ml = 0
                for w in range(ne):
                    compares += 1
                    if wd[b, w, t] != wd[b, w, c]:
                        x = int(wd[b, w, t] ^ wd[b, w, c]) & 0xFFFFFFFF
                        ml += ((x & -x).bit_length() - 1) // 8
                        break
                    ml += 4
                if min(ml, 258, limit[b] - t) != 4 * ne:
                    continue
                for j in range(nf):
                    compares += 1
                    if wd[b, ne + j, t] != wd[b, ne + j, c]:
                        break
    assert (stats["visits"], stats["compares"]) == (visits, compares)
    assert visits > 0 and compares > visits // 2


# ---------------------------------------------------------------------------
# what B2's kernel relies on: words rebuilt from the window, an order-free
# top-2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ne,hash_bytes,cut", [(1, 3, 0), (1, 4, 0),
                                               (2, 4, 0), (8, 4, 3),
                                               (16, 4, 1), (1, 3, 2)])
def test_window_words_equal_prep(ne, hash_bytes, cut):
    """The ne carry words of every position built from the window bytes
    as the kernel stages them (aligned u32 words, funnel shift, word 0
    masked in the 3-byte pass, zero past W; `cut` makes W no multiple of
    4) equal the JAX prep's words, pad positions and the zero tail
    included."""
    win = tt(windows("mixed", seed=9)[:, :CTX + S - cut])
    win[:, -5:] = 0xAB                        # nonzero bytes up to W
    W = win.shape[1]
    _, words = _jax_words(win.numpy(), ne, 0, hash_bytes)
    got = _all_words(win, ne, hash_bytes)
    np.testing.assert_array_equal(u32(got), u32(words))
    # the last position of the row reads its byte, then zeros past W
    assert (u32(got)[:, 0, W - 1] == 0xAB).all()


@pytest.mark.parametrize("fp", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_top2_is_the_two_largest_scores(kind, fp):
    """The serial scan's best and runner-up are the two largest candidate
    scores (torch.topk over the stacked candidates of each row): the scan
    order does not matter.  Both equal the JAX package's top-2 pass."""
    win = windows(kind, seed=17)
    min_src = np.asarray([0, CTX - 100], np.int32)
    limit = np.asarray([CTX + S, CTX + 2500], np.int32)
    K, nw = 12, 8
    ne, nf = match2._split_words(nw, fp)
    W = win.shape[1]
    key, fps = match2._prep(tt(win), ne, 4, nf)
    skey, order = torch.sort(key, dim=1)
    args = (skey, order, tt(win), fps, tt(min_src), tt(limit))
    best, sec = match2._run_matcher_plain(*args, W, K, 32768, ne, top2=True)
    cands = list(match2._candidates(*args, K, 32768, ne))
    score = torch.stack([c[0] for c in cands], dim=2)
    ld = torch.stack([c[1] for c in cands], dim=2)
    top, at = torch.topk(score, 2, dim=2)
    # scores of a row's matches are distinct
    assert ((top[..., 0] != top[..., 1]) | (top[..., 0] < 0)).all()
    lds = torch.where(top >= 0, torch.gather(ld, 2, at), 0)
    assert torch.equal(match2._unsort(lds[..., 0], order, W), best)
    assert torch.equal(match2._unsort(lds[..., 1], order, W), sec)
    jld, jld2 = j_match2._candidate_pass(
        jnp.asarray(win), jnp.asarray(min_src), jnp.asarray(limit), K=K,
        nw=nw, hash_bytes=4, max_dist=32768, interpret=True, fp=fp,
        top2=True)
    np.testing.assert_array_equal(u32(best), u32(jld))
    np.testing.assert_array_equal(u32(sec), u32(jld2))
    if kind != "random":
        assert (u32(sec) != 0).any()
