"""Port match2 against the JAX fused matcher (Pallas, interpret mode):
_prep contents, the candidate pass and find_matches_fused for the (K, nw,
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


@pytest.mark.parametrize("nw,hash_bytes", [(2, 4), (4, 4), (16, 4), (1, 3)])
def test_prep_contents_equal(nw, hash_bytes):
    """Keys and carry words, compared by content (the TPU tiles its words
    as (T, nw, 8, 1024); the port keeps (nw, Wp))."""
    win = windows("mixed", seed=2)
    B, W = win.shape
    jkey, jwords = j_match2._prep(jnp.asarray(win), nw, 0, hash_bytes,
                                  interpret=True)
    jwords = np.asarray(jwords)
    T = jwords.shape[1]
    jwords = jwords.transpose(0, 2, 1, 3, 4).reshape(B, nw, T * 8 * 1024)
    key, words = match2._prep(tt(win), nw, hash_bytes)
    np.testing.assert_array_equal(u32(key), u32(jkey))
    np.testing.assert_array_equal(u32(words), u32(jwords))


@pytest.mark.parametrize("K,nw,hash_bytes,max_dist",
                         [(4, 2, 4, 32768), (12, 4, 4, 32768),
                          (12, 1, 3, 4096), (16, 1, 3, 4096)])
@pytest.mark.parametrize("kind", ["text", "runs"])
def test_candidate_pass_equal(kind, K, nw, hash_bytes, max_dist):
    """Sort + matcher + unsort, including the 3-byte K3 passes of rows
    8 and 9 (K3 = 12, 16)."""
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
    """ne exact words, then nf FNV fingerprint words (u32 wraparound)."""
    win = windows("mixed", seed=6)
    B, W = win.shape
    ne, nf = match2._split_words(nw, fp)
    assert (ne, nf) == j_match2._split_words(nw, fp)
    assert nf > 0
    jkey, jwords = j_match2._prep(jnp.asarray(win), ne, nf, 4,
                                  interpret=True)
    jwords = np.asarray(jwords)
    T = jwords.shape[1]
    jwords = jwords.transpose(0, 2, 1, 3, 4).reshape(B, ne + nf, T * 8 * 1024)
    key, words = match2._prep(tt(win), ne, 4, nf)
    np.testing.assert_array_equal(u32(key), u32(jkey))
    np.testing.assert_array_equal(u32(words), u32(jwords))


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
    """stats= counts what a serial scan does on the data: one bucket test
    per same-bucket candidate within K, then for a valid candidate one
    compare per exact word up to the first that differs and, past a full
    exact run, per fingerprint word likewise.  The outputs do not change."""
    K, max_dist = 8, 32768
    win = tt(windows("mixed", seed=5))
    W = win.shape[1]
    min_src = np.asarray([0, CTX - 100], np.int32)
    limit = np.asarray([CTX + S, CTX + 2500], np.int32)
    key, words = match2._prep(win, ne, 4, nf)
    skey, order = torch.sort(key, dim=1)
    args = (skey, order, words, tt(min_src), tt(limit), W, K, max_dist, nf)
    stats = {}
    counted = match2._run_matcher_plain(*args, stats=stats)
    assert torch.equal(counted, match2._run_matcher_plain(*args))
    sk, wd = skey.numpy(), words.numpy()
    visits = compares = 0
    for b in range(sk.shape[0]):
        live = sk[b][sk[b] != match2.SENTINEL]
        pos = live & match2.POS_MASK
        bucket = live >> match2.POS_BITS
        for i in range(len(live)):
            for k in range(1, min(K, i) + 1):
                if bucket[i - k] != bucket[i]:
                    break
                visits += 1
                t, c = int(pos[i]), int(pos[i - k])
                if not (1 <= t - c <= max_dist and min_src[b] <= c < limit[b]):
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
