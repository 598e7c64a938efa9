"""The round-1 matcher on the device: best (len, dist) per window position.

Counterpart of flate_tpu/jx/match.py: _pack_words_u32 (:43), _tz_bytes_u32
(:62), _match_len (:71), _hashes (:83), _unsort_scatter (:100),
_candidate_best (:113) and find_matches_device (:240).  Batch-wise over
(B, W) windows:

1. each position's next 4 * nwords bytes packed into nwords u32 words
   (int32 bit patterns: XOR and zero tests do not depend on the sign);
2. a stable argsort by a 15-bit hash of the next 4 (or 3) bytes: the K
   most recent same-hash predecessors of a position are the K rows before
   it in sorted order, so scoring candidate k compares the sorted words
   with themselves k rows back (the JAX package rolls the row);
3. match length within the carried bytes = zero bytes of the XOR'd words;
4. exact lengths past that: small-distance runs (runs.small_dist_runs,
   kernel B3 on the card) and same-distance chains past the cap
   (runs.extend_chains, kernel B4 on the card), both with limit = W,
   the twins of the JAX package's _small_dist_runs (:154) and
   _extend_chains (:194);
5. one scatter returns the sorted results to position order.
"""

from __future__ import annotations

import torch

from .. import consts
from . import runs, to_i32

CTX = consts.MAX_DISTANCE            # context bytes before each shard
SCORE_SHIFT = 16                     # score = (len << 16) - dist


def _pack_words(window: torch.Tensor, nwords: int) -> torch.Tensor:
    """out[b, i, t] = bytes window[b, i+4t .. i+4t+4) packed LE into a
    u32, as int32 bit patterns, shape (B, W, nwords); reads past the end
    see zeros."""
    B, W = window.shape
    ext = torch.nn.functional.pad(window, (0, 4 * nwords + 4)).to(torch.int64)
    words = []
    for t in range(nwords):
        w = ext[:, 4 * t:4 * t + W].clone()
        for j in range(1, 4):
            w |= ext[:, 4 * t + j:4 * t + j + W] << (8 * j)
        words.append(to_i32(w))
    return torch.stack(words, dim=2)


def _tz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Count of low-order zero bytes (0..4) of u32 bit patterns."""
    return (((x & 0xFF) == 0).to(torch.int32) + ((x & 0xFFFF) == 0)
            + ((x & 0xFFFFFF) == 0) + (x == 0))


def _match_len(words_a: torch.Tensor, words_b: torch.Tensor) -> torch.Tensor:
    """Common-prefix byte length of (B, N, nw) word rows: the zero bytes
    below the first differing word's first nonzero byte."""
    x = words_a ^ words_b
    nz = x != 0
    nw = x.shape[-1]
    first = torch.where(nz.any(dim=-1), nz.to(torch.int8).argmax(dim=-1), nw)
    xf = torch.gather(x, -1, torch.clamp(first, max=nw - 1)[..., None])[..., 0]
    return torch.where(first == nw, 4 * nw, 4 * first + _tz_bytes(xf))


def _hashes(window: torch.Tensor, nbytes: int) -> torch.Tensor:
    """15-bit Fibonacci hash of each position's next `nbytes` bytes
    (big-endian); positions lacking a full prefix get unique buckets
    past 2^15 that match nothing.  The u32 product is taken mod 2^32 in
    two 16-bit halves of the multiplier, with no int64 overflow."""
    B, W = window.shape
    ext = torch.nn.functional.pad(window, (0, nbytes)).to(torch.int64)
    v = torch.zeros((B, W), dtype=torch.int64, device=window.device)
    for j in range(nbytes):
        v = (v << 8) | ext[:, j:j + W]
    lo, hi = consts.HASH_MUL & 0xFFFF, consts.HASH_MUL >> 16
    prod = (v * lo + (((v * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF
    h = prod >> (32 - consts.LOOKUP_BITS)
    pos = torch.arange(W, dtype=torch.int64, device=window.device)[None, :]
    return torch.where(pos >= W - (nbytes - 1),
                       (1 << consts.LOOKUP_BITS) + pos, h)


def _candidate_best(h: torch.Tensor, words: torch.Tensor, K: int,
                    min_src: torch.Tensor, min_len: int
                    ) -> tuple[torch.Tensor, ...]:
    """Score the K sorted same-hash predecessors of every position;
    returns (best_len, best_dist, best_score) (B, W) int32 in position
    order.  Candidate k of sorted row i is sorted row i - k: rows i < k
    have none (the JAX package's roll wraps them around, and its
    `pos >= k` test drops them)."""
    B, W = h.shape
    nw = words.shape[-1]
    spos = torch.argsort(h, dim=-1, stable=True)
    sh = torch.gather(h, 1, spos)
    swords = torch.gather(words, 1, spos[:, :, None].expand(B, W, nw))
    spos = spos.to(torch.int32)
    smaxlen = torch.clamp(W - spos, max=consts.MAX_MATCH_LEN)
    ms = min_src.to(torch.int32)[:, None]
    best_score = torch.full((B, W), -1, dtype=torch.int32, device=h.device)
    best_len = torch.zeros_like(best_score)
    best_dist = torch.zeros_like(best_score)
    for k in range(1, min(K, W - 1) + 1):
        cpos = spos[:, :W - k]
        dist = spos[:, k:] - cpos
        valid = ((sh[:, k:] == sh[:, :W - k]) & (dist >= 1)
                 & (dist <= consts.MAX_DISTANCE) & (cpos >= ms))
        ml = torch.minimum(_match_len(swords[:, k:], swords[:, :W - k]),
                           smaxlen[:, k:])
        score = torch.where(valid & (ml >= min_len),
                            (ml << SCORE_SHIFT) - dist, -1)
        bs = best_score[:, k:]
        upd = score > bs
        best_score[:, k:] = torch.where(upd, score, bs)
        best_len[:, k:] = torch.where(upd, ml, best_len[:, k:])
        best_dist[:, k:] = torch.where(upd, dist, best_dist[:, k:])
    spos = spos.to(torch.int64)
    return tuple(torch.empty_like(v).scatter_(1, spos, v)
                 for v in (best_len, best_dist, best_score))


def find_matches_device(window: torch.Tensor, ctx_len: torch.Tensor,
                        K: int = 64, K3: int = 8, min_len: int = 3,
                        ctx: int = CTX, nwords: int = 8
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best (len, dist) per window position, (B, W) int32 each.

    window: (B, W) uint8 = [ctx context bytes | shard bytes] a row;
    positions below ctx - ctx_len[b] are invalid sources (unprimed
    context).  Context positions get matches too; the parse ignores
    them."""
    B, W = window.shape
    dev = window.device
    min_src = (ctx - ctx_len.to(torch.int64)).to(torch.int32)
    limit = torch.full((B,), W, dtype=torch.int32, device=dev)

    # main table: 4-byte hash, 4 * nwords carried bytes
    mlen, mdist, mscore = _candidate_best(
        _hashes(window, 4), _pack_words(window, nwords), K, min_src, min_len)

    # secondary table: 3-byte hash, 8 carried bytes (len 3..8 discovery)
    mlen3, mdist3, mscore3 = _candidate_best(
        _hashes(window, 3), _pack_words(window, 2), K3, min_src, min_len)
    upd = mscore3 > mscore
    mlen = torch.where(upd, mlen3, mlen)
    mdist = torch.where(upd, mdist3, mdist)
    mscore = torch.maximum(mscore, mscore3)

    # small-distance exact runs (full lengths, no cap): kernel B3
    rlen, rdist = runs.small_dist_runs(window, limit, min_src)
    rscore = torch.where(rlen >= consts.MIN_MATCH_LEN,
                         (rlen << SCORE_SHIFT) - rdist, -1)
    upd = rscore > mscore
    mlen = torch.where(upd, rlen, mlen).contiguous()
    mdist = torch.where(upd, rdist, mdist).contiguous()

    # same-distance extension past the carry cap: kernel B4
    mlen = runs.extend_chains(mlen, mdist, limit, cap=4 * nwords)

    # too-far heuristic for minimum-length matches
    drop = (mlen == consts.MIN_MATCH_LEN) & (mdist > 4096)
    return torch.where(drop, 0, mlen), torch.where(drop, 0, mdist)
