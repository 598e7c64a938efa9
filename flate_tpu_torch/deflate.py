"""The host tail encoder: LZ77 tokens of one shard in numpy.

The port's copy of flate_tpu/deflate.py's shard tokenizer (:50-286), which
the round-1 encoder (device/pipeline.py) runs on its last partial shard
and on empty input:

1. hash every position's 4-byte prefix (and 3-byte, for length-3
   matches) with a 15-bit Fibonacci hash;
2. rank positions by (hash, pos) with one sort: the K most recent
   same-hash predecessors of a position are its candidates;
3. score them with one 32-byte compare, extend the top 3 to 258;
4. the one-step lazy rule as a per-position decision, the token starts
   by pointer doubling over the successor array;
5. at levels 4-9, two rounds of the cost-model-optimal re-parse
   (_squeeze: histogram -> code costs -> the host C parse DP).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build, consts, tables
from .block import Tokens, token_histograms
from .huffman import huffman_code_lengths

# emit a length-3 match only when it is close enough to be worth it
# (zlib's TOO_FAR heuristic)
TOO_FAR = 4096


def _hash4(window: np.ndarray) -> np.ndarray:
    """15-bit Fibonacci hash of each position's next 4 bytes."""
    w = window.astype(np.uint32)
    v = (w[:-3] << 24) | (w[1:-2] << 16) | (w[2:-1] << 8) | w[3:]
    h = (v * np.uint32(consts.HASH_MUL)) >> np.uint32(32 - consts.LOOKUP_BITS)
    return h.astype(np.int64)


def _hash3(window: np.ndarray) -> np.ndarray:
    """15-bit hash of each position's next 3 bytes (length-3 matches)."""
    w = window.astype(np.uint32)
    v = (w[:-2] << 16) | (w[1:-1] << 8) | w[2:]
    h = (v * np.uint32(consts.HASH_MUL)) >> np.uint32(32 - consts.LOOKUP_BITS)
    return h.astype(np.int64)


def _recent_candidates(h: np.ndarray, pos: np.ndarray, K: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(cand, valid): the K most recent positions with the same hash value
    preceding each position in `pos`, via one (hash, pos) sort."""
    npos = h.size
    key = h * np.int64(npos) + np.arange(npos, dtype=np.int64)
    order = np.argsort(key, kind="stable")
    rank = np.empty(npos, dtype=np.int64)
    rank[order] = np.arange(npos, dtype=np.int64)
    r = rank[pos]
    cand_rank = r[None, :] - np.arange(1, K + 1, dtype=np.int64)[:, None]
    valid = cand_rank >= 0
    cand = order[np.clip(cand_rank, 0, None)]          # (K, P)
    valid &= h[cand] == h[pos][None, :]
    dist = pos[None, :] - cand
    valid &= (dist >= consts.MIN_DISTANCE) & (dist <= consts.MAX_DISTANCE)
    return cand, valid


def find_matches(window: np.ndarray, start: int, K: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Best match (len, dist) for every position >= start of window
    (context + shard bytes).  Returns (mlen, mdist) for positions
    start..W-1; a match never passes the window's end and reaches at most
    MAX_DISTANCE back."""
    W = window.size
    N = W - start
    mlen = np.zeros(N, dtype=np.int32)
    mdist = np.zeros(N, dtype=np.int32)
    if W < 4 or N <= 0:
        return mlen, mdist

    h4 = _hash4(window)                     # hashes for pos 0..W-4
    pos = np.arange(start, W - 3, dtype=np.int64)
    if pos.size == 0:
        return mlen, mdist
    cand4, valid4 = _recent_candidates(h4, pos, K)

    # secondary 3-byte-hash table for the length-3 matches the 4-byte
    # hash cannot see (a few most recent candidates suffice: a length-3
    # match is only emitted when close)
    K3 = min(8, K)
    h3 = _hash3(window)[:h4.size]           # align position ranges
    cand3, valid3 = _recent_candidates(h3, pos, K3)

    cand = np.concatenate([cand4, cand3], axis=0)      # (K+K3, P)
    valid = np.concatenate([valid4, valid3], axis=0)
    dist = pos[None, :] - cand

    # tier 1: match length capped at 32 via one vectorized compare
    CAP = 32
    padded = np.concatenate([window, np.zeros(CAP, dtype=np.uint8)])
    view = np.lib.stride_tricks.sliding_window_view(padded, CAP)  # (W+1, CAP)
    eq = view[cand] == view[pos][None, :]               # (K, P, CAP) bool
    len32 = np.cumprod(eq, axis=2, dtype=np.uint8).sum(axis=2).astype(np.int32)
    len32 = np.where(valid, len32, 0)
    # clamp to the window's end (the zero padding can only inflate)
    maxlen = np.minimum(consts.MAX_MATCH_LEN, W - pos).astype(np.int32)
    len32 = np.minimum(len32, maxlen[None, :])

    # rank candidates: longest, then closest
    score = (len32.astype(np.int64) << 17) - dist
    score = np.where(valid & (len32 >= consts.MIN_MATCH_LEN), score, -1)
    P = pos.size
    ar = np.arange(P)

    def _extend(cpos: np.ndarray, cdist: np.ndarray, clen: np.ndarray
                ) -> np.ndarray:
        """tier 2: extend cap-hit matches to the full 258 limit."""
        clen = clen.copy()
        csrc = cpos - cdist
        lim = np.minimum(consts.MAX_MATCH_LEN, W - cpos).astype(np.int32)
        alive = (clen == CAP) & (lim > CAP)
        for _ in range(1, (consts.MAX_MATCH_LEN + CAP - 1) // CAP + 1):
            idx = np.flatnonzero(alive)
            if idx.size == 0:
                break
            o = clen[idx]
            e = view[csrc[idx] + o] == view[cpos[idx] + o]
            ext = np.cumprod(e, axis=1, dtype=np.uint8).sum(axis=1)
            clen[idx] = np.minimum(clen[idx] + ext.astype(np.int32), lim[idx])
            alive[idx] = (ext == CAP) & (clen[idx] < lim[idx])
        return clen

    # candidates capped at 32 bytes tie in the tier-1 ranking: extend the
    # top 3 per position to full length before choosing
    T = min(3, score.shape[0])
    top = np.argpartition(-score, T - 1, axis=0)[:T]    # (T, P)
    tlen = len32[top, ar[None, :]]
    tdist = dist[top, ar[None, :]].astype(np.int32)
    tvalid = score[top, ar[None, :]] >= 0
    need = tvalid & (tlen == CAP)
    if need.any():
        flat = np.flatnonzero(need.ravel())
        cpos = np.broadcast_to(pos[None, :], tlen.shape).ravel()[flat]
        elen = _extend(cpos, tdist.ravel()[flat], tlen.ravel()[flat])
        tlen_flat = tlen.ravel().copy()
        tlen_flat[flat] = elen
        tlen = tlen_flat.reshape(tlen.shape)
    tscore = (tlen.astype(np.int64) << 17) - tdist
    tscore = np.where(tvalid, tscore, -1)
    bi = np.argmax(tscore, axis=0)
    blen = tlen[bi, ar]
    bdist = tdist[bi, ar]
    bvalid = tscore[bi, ar] >= 0

    # too-far heuristic for minimum-length matches
    bvalid &= ~((blen == 3) & (bdist > TOO_FAR))

    out_idx = (pos - start).astype(np.int64)
    mlen[out_idx] = np.where(bvalid, blen, 0)
    mdist[out_idx] = np.where(bvalid, bdist, 0)
    return mlen, mdist


def lazy_parse(mlen: np.ndarray, mdist: np.ndarray,
               lazy: bool, max_lazy: int) -> np.ndarray:
    """Token-start mask of the greedy / one-step-lazy parse by pointer
    doubling: a match is deferred in favour of a literal when the next
    position holds a strictly longer match and it is below max_lazy."""
    N = mlen.size
    take = mlen >= consts.MIN_MATCH_LEN
    if lazy and N > 1:
        nxt_len = np.concatenate([mlen[1:], [0]])
        defer = (nxt_len > mlen) & (mlen < max_lazy)
        take &= ~defer
    step = np.where(take, np.maximum(mlen, 1), 1).astype(np.int64)
    nxt = np.minimum(np.arange(N, dtype=np.int64) + step, N)

    # pointer doubling: mark every position reachable from 0 via nxt[]
    on = np.zeros(N + 1, dtype=bool)
    on[0] = True
    jump = np.concatenate([nxt, [N]])
    rounds = max(1, int(np.ceil(np.log2(max(N, 2)))))
    for _ in range(rounds):
        np.maximum.at(on, jump[on.nonzero()[0]], True)
        jump = jump[jump]
    return on[:N]


def tokenize_shard(data: np.ndarray, context: np.ndarray | None,
                   level: int) -> Tokens:
    """The token stream of one shard, primed with up to 32 KiB of
    context."""
    if level not in consts.LEVEL_PARAMS:
        raise ValueError(
            f"invalid compression level {level}: expected one of "
            f"{sorted(consts.LEVEL_PARAMS)}")
    K, _nice, lazy, max_lazy = consts.LEVEL_PARAMS[level]
    data = np.asarray(data, dtype=np.uint8)
    if context is None or context.size == 0:
        window = data
        start = 0
    else:
        context = np.asarray(context[-consts.MAX_DISTANCE:], dtype=np.uint8)
        window = np.concatenate([context, data])
        start = context.size

    mlen, mdist = find_matches(window, start, K)
    starts = lazy_parse(mlen, mdist, lazy, max_lazy)
    idx = np.flatnonzero(starts)
    # the take-match decision lazy_parse stepped with: a position on the
    # path emits its match iff it was not deferred there
    if lazy:
        nxt_len = np.concatenate([mlen[1:], [0]])
        defer = (nxt_len > mlen) & (mlen < max_lazy)
        decided = (mlen >= consts.MIN_MATCH_LEN) & ~defer
    else:
        decided = mlen >= consts.MIN_MATCH_LEN
    length = np.where(decided[idx], mlen[idx], 0).astype(np.int32)
    dist = np.where(decided[idx], mdist[idx], 0).astype(np.int32)
    toks = Tokens(lit=data[idx], length=length, dist=dist)
    if level >= 4:
        # levels 1-3 stay greedy-only as the speed tier
        toks = _squeeze(data, mlen, mdist, toks)
    return toks


def optimal_parse(mlen: np.ndarray, mdist: np.ndarray, data: np.ndarray,
                  lit_bits: np.ndarray, lenc_bits: np.ndarray,
                  dist_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Cost-optimal token parse by the host C DP (csrc/host_encode.c):
    (take mask u8, selected length i32) per position.  lit_bits [256],
    lenc_bits [29] and dist_bits [30] are float32 costs in bits."""
    n = mlen.size
    if not (mdist.size == data.size == n and lit_bits.size == 256
            and lenc_bits.size == 29 and dist_bits.size == 30):
        raise ValueError("optimal_parse: mlen, mdist and data must have one "
                         "size, the cost tables 256, 29 and 30 entries")
    mlen = np.ascontiguousarray(mlen, dtype=np.int32)
    mdist = np.ascontiguousarray(mdist, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    costs = [np.ascontiguousarray(c, dtype=np.float32)
             for c in (lit_bits, lenc_bits, dist_bits)]
    sel = np.zeros(n, dtype=np.int32)
    take = np.zeros(n, dtype=np.uint8)
    ptr = ctypes.c_void_p
    rc = _build.host_library().optimal_parse(
        mlen.ctypes.data_as(ptr), mdist.ctypes.data_as(ptr), n,
        data.ctypes.data_as(ptr), *(c.ctypes.data_as(ptr) for c in costs),
        sel.ctypes.data_as(ptr), take.ctypes.data_as(ptr))
    if rc != 0:
        raise MemoryError(f"optimal_parse: no memory for {n + 1} costs")
    return take, sel


def _squeeze(data: np.ndarray, mlen: np.ndarray, mdist: np.ndarray,
             toks: Tokens, iterations: int = 2) -> Tokens:
    """Cost-model-optimal re-parse (zopfli-style squeeze): iterate
    histogram -> code costs -> the C DP parse."""
    for _ in range(iterations):
        freq_ll, freq_d = token_histograms(toks)
        ll_lens = huffman_code_lengths(freq_ll, consts.MAX_CODE_BITS)
        d_lens = huffman_code_lengths(freq_d, consts.MAX_CODE_BITS)
        # unused symbols get a mild fallback cost so the DP may still
        # introduce them when clearly profitable
        lit_bits = np.where(ll_lens[:256] > 0, ll_lens[:256], 13)
        lenc = np.where(ll_lens[257:286] > 0, ll_lens[257:286], 13)
        lenc_bits = lenc + tables.LENGTH_EXTRA_BITS
        db = np.where(d_lens > 0, d_lens, 13)
        dist_bits = db + tables.DIST_EXTRA_BITS
        take, sel = optimal_parse(mlen, mdist, data, lit_bits, lenc_bits,
                                  dist_bits)
        idx = np.flatnonzero(take)
        length = sel[idx].astype(np.int32)
        dist = np.where(length > 0, mdist[idx], 0).astype(np.int32)
        toks = Tokens(lit=data[idx], length=length, dist=dist)
    return toks
