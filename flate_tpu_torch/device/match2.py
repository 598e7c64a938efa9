"""LZ77 match search: sorted-neighbour candidate scan.

Counterpart of flate_tpu/jx/match2.py:find_matches_fused (:365),
including the opt-in fingerprint-ranked scan (fp=True) with its top-2
chain extension.  Positions are sorted by (14-bit hash of the next bytes, pos);
after sorting, the K most recent same-hash predecessors of a position are
the K previous rows.  Any candidate that passes the byte comparison is a
valid back-reference, so bucket collisions are harmless.

The TPU carries the window words through its sort because gathers
scalarize there.  Keys are unique (pos sits in the low 18 bits), so here a
key-only torch.sort gives the identical order, the matcher reads the words
by position, and the unsort is an inverse-permutation scatter (fused into
the CUDA matcher).

Kernels (csrc/encode_kernels.cu): B1 `_prep`, B2 `_run_matcher`.
"""

from __future__ import annotations

import torch

from .. import _build, consts
from . import runs, to_i32

CTX = consts.MAX_DISTANCE        # context bytes prepended to each shard
SCORE_SHIFT = 16                 # score = (len << 16) - dist; dist <= 32768
TILE = 8192                      # key rows are padded to a multiple of this
POS_BITS = 18                    # window <= 256 KiB positions
POS_MASK = (1 << POS_BITS) - 1
HASH_BITS = 32 - POS_BITS        # 14-bit buckets
SENTINEL = 0xFFFFFFFF
_M32 = 0xFFFFFFFF
FP_MUL = 0x01000193              # FNV prime: the fingerprint polynomial


def _mul_u32(v: torch.Tensor, m: int) -> torch.Tensor:
    """(v * m) mod 2**32 for u32 values in int64, without int64 overflow:
    the multiplier is split into 16-bit halves."""
    lo = v * (m & 0xFFFF)
    hi = ((v * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _split_words(nw: int, fp: bool | int = False) -> tuple[int, int]:
    """Selection reach 4*nw bytes = ne exact carry words + nf fingerprint
    words, fingerprint j covering the words [ne*2^j, ne*2^(j+1)).
    Fingerprints only rank candidates (a collision merely mis-ranks);
    emitted lengths come from the exact words.  fp=False: all exact
    (ne = nw); fp=True: ne = 2; fp=<int> pins ne."""
    if not fp:
        return nw, 0
    ne = min(nw, fp if isinstance(fp, int) and fp is not True else 2)
    nf = 0
    reach = ne
    while reach < nw:
        reach *= 2
        nf += 1
    if reach != nw:
        raise ValueError(f"nw must be ne*2^k, got {nw}")
    return ne, nf


# ---------------------------------------------------------------------------
# B1: prep — sort keys, carry words and fingerprint words
# ---------------------------------------------------------------------------

def _prep_plain(window: torch.Tensor, ne: int, hash_bytes: int, nf: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    B, W = window.shape
    Wp = -(-W // TILE) * TILE
    nbytes = max(4 * ne << nf, hash_bytes)
    wpad = torch.nn.functional.pad(window.to(torch.int64),
                                   (0, Wp - W + nbytes))
    planes = [wpad[:, j:j + Wp] for j in range(nbytes)]

    def le_word(w):
        return (planes[4 * w] | (planes[4 * w + 1] << 8)
                | (planes[4 * w + 2] << 16) | (planes[4 * w + 3] << 24))

    words = []
    for w in range(ne):
        le = le_word(w)
        if w == 0 and hash_bytes < 4:
            le = le & ((1 << (8 * hash_bytes)) - 1)
        words.append(to_i32(le))
    for j in range(nf):
        lo, hi = ne << j, ne << (j + 1)
        fp = le_word(lo)
        for w in range(lo + 1, hi):
            fp = (_mul_u32(fp, FP_MUL) + le_word(w)) & _M32
        words.append(to_i32(fp))
    v = planes[0]
    for j in range(1, hash_bytes):
        v = (v << 8) | planes[j]
    h = _mul_u32(v, consts.HASH_MUL) >> (32 - HASH_BITS)
    pos = torch.arange(Wp, dtype=torch.int64, device=window.device)[None, :]
    key = torch.where(pos < W, (h << POS_BITS) | pos, SENTINEL)
    return key, torch.stack(words, dim=1)


def _prep(window: torch.Tensor, ne: int, hash_bytes: int, nf: int = 0
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """window (B, W) uint8 -> (key (B, Wp) int64, words (B, ne+nf, Wp)
    int32 u32 bit patterns: ne exact little-endian words, then nf FNV
    fingerprints of the following spans), Wp = W rounded up to TILE."""
    if _build.use_plain(window):
        return _prep_plain(window, ne, hash_bytes, nf)
    B, W = window.shape
    Wp = -(-W // TILE) * TILE
    _build.check_cuda("prep.window", window, torch.uint8, (B, W))
    key = torch.empty((B, Wp), dtype=torch.int64, device=window.device)
    words = torch.empty((B, ne + nf, Wp), dtype=torch.int32,
                        device=window.device)
    _build.launch("flate_prep", window.data_ptr(), key.data_ptr(),
                  words.data_ptr(), B, W, Wp, ne, nf, hash_bytes)
    return key, words


# ---------------------------------------------------------------------------
# B2: matcher — K sorted predecessors, scattered back to position order
# ---------------------------------------------------------------------------

def _tz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero bytes of a u32 (0..4): equal leading bytes of two
    little-endian words."""
    cnt = ((x & 0xFF) == 0).to(torch.int32)
    cnt = cnt + ((x & 0xFFFF) == 0).to(torch.int32)
    cnt = cnt + ((x & 0xFFFFFF) == 0).to(torch.int32)
    return cnt + (x == 0).to(torch.int32)


def _run_matcher_plain(skey: torch.Tensor, order: torch.Tensor,
                       words: torch.Tensor, min_src: torch.Tensor,
                       limit: torch.Tensor, W: int, K: int,
                       max_dist: int, nf: int = 0, top2: bool = False,
                       stats: dict | None = None):
    """The scan as K whole-row shifts.  With `stats`, also counts what the
    data asks of any scan: stats["visits"] same-bucket candidates within K
    (one bucket test each) and stats["compares"] word compares, one per
    exact word up to and including the first that differs and one per
    fingerprint word likewise, for the valid candidates."""
    B, Wp = skey.shape
    nc = words.shape[1]
    ne = nc - nf
    cap = 4 * ne
    tpos = (skey & POS_MASK).to(torch.int32)
    tbucket = skey >> POS_BITS
    tw = [torch.gather(words[:, t].to(torch.int64) & _M32, 1, order)
          for t in range(nc)]                       # words in sorted order
    ms = min_src.to(torch.int32)[:, None]
    lim = limit.to(torch.int32)[:, None]
    maxlen = torch.clamp(lim - tpos, max=consts.MAX_MATCH_LEN)

    def back(x, d, fill):
        return torch.nn.functional.pad(x[:, :Wp - d], (d, 0), value=fill)

    def blank(fill):
        return torch.full((B, Wp), fill, dtype=torch.int32,
                          device=skey.device)

    best_score, best_ld = blank(-1), blank(0)
    sec_score, sec_ld = blank(-1), blank(0)
    visits = torch.zeros((), dtype=torch.int64, device=skey.device)
    compares = torch.zeros_like(visits)
    for d in range(1, K + 1):
        ck = back(skey, d, SENTINEL)
        cpos = (ck & POS_MASK).to(torch.int32)
        dist = tpos - cpos
        valid = ((ck >> POS_BITS) == tbucket) & (dist >= 1) \
            & (dist <= max_dist) & (cpos >= ms) & (cpos < lim)
        ml = torch.zeros_like(tpos)
        run = torch.ones_like(valid)
        if stats is not None:
            visits += ((ck >> POS_BITS == tbucket) & (skey != SENTINEL)).sum()
        for t in range(ne):
            if stats is not None:
                compares += (valid & run).sum()
            c = _tz_bytes(tw[t] ^ back(tw[t], d, 0))
            ml = ml + torch.where(run, c, 0)
            run = run & (c == 4)
        ml = torch.minimum(ml, maxlen)
        # the fingerprints themselves are compared, so a collision ranks
        # a candidate as the reference ranks it
        est = ml
        fp_run = ml == cap
        for j in range(nf):
            if stats is not None:
                compares += (valid & fp_run).sum()
            fp_run = fp_run & (tw[ne + j] == back(tw[ne + j], d, 0))
            est = est + torch.where(fp_run, cap << j, 0)
        score = (est << 16) - dist
        ld = (ml << 16) | dist
        ok = valid & (ml >= consts.MIN_MATCH_LEN)
        upd = ok & (score > best_score)
        if top2:
            # demote the old best, else replace the runner-up: the result
            # depends on the order of the candidates
            upd2 = ok & ~upd & (score > sec_score)
            sec_score = torch.where(upd, best_score,
                                    torch.where(upd2, score, sec_score))
            sec_ld = torch.where(upd, best_ld,
                                 torch.where(upd2, ld, sec_ld))
        best_score = torch.where(upd, score, best_score)
        best_ld = torch.where(upd, ld, best_ld)

    def unsort(x):
        # order is a permutation of [0, Wp); rows of pad positions land at
        # >= W and are cut
        return torch.empty_like(x).scatter_(1, order, x)[:, :W]

    if stats is not None:
        stats["visits"] = int(visits)
        stats["compares"] = int(compares)
    if top2:
        return unsort(best_ld), unsort(sec_ld)
    return unsort(best_ld)


def _run_matcher(skey: torch.Tensor, order: torch.Tensor,
                 words: torch.Tensor, min_src: torch.Tensor,
                 limit: torch.Tensor, W: int, K: int,
                 max_dist: int, nf: int = 0, top2: bool = False):
    """skey (B, Wp) int64 sorted keys, order (B, Wp) their positions,
    words (B, ne+nf, Wp) int32 by position, the last nf of them
    fingerprints that rank only.  Returns best len<<16|dist (B, W) int32
    in position order, and the runner-up beside it when top2."""
    if _build.use_plain(skey):
        return _run_matcher_plain(skey, order, words, min_src, limit, W, K,
                                  max_dist, nf, top2)
    B, Wp = skey.shape
    nc = words.shape[1]
    min_src = min_src.to(torch.int32).contiguous()
    limit = limit.to(torch.int32).contiguous()
    _build.check_cuda("matcher.skey", skey, torch.int64, (B, Wp))
    _build.check_cuda("matcher.words", words, torch.int32, (B, nc, Wp))
    _build.check_cuda("matcher.min_src", min_src, torch.int32, (B,))
    _build.check_cuda("matcher.limit", limit, torch.int32, (B,))
    if W > Wp or Wp > (1 << POS_BITS) - 1:
        raise ValueError(f"window {W} exceeds the {POS_BITS}-bit positions")
    if not 0 <= nf < nc:
        raise ValueError(f"nf {nf} must leave an exact word of {nc}")
    out = torch.empty((B, W), dtype=torch.int32, device=skey.device)
    out2 = torch.empty_like(out) if top2 else None
    _build.launch("flate_matcher", skey.data_ptr(), words.data_ptr(),
                  min_src.data_ptr(), limit.data_ptr(), out.data_ptr(),
                  out2.data_ptr() if top2 else None,
                  B, W, Wp, nc - nf, nf, K, max_dist)
    return (out, out2) if top2 else out


def _candidate_pass(window: torch.Tensor, min_src: torch.Tensor,
                    limit: torch.Tensor, *, K: int, nw: int,
                    hash_bytes: int, max_dist: int, fp: bool | int = False,
                    top2: bool = False):
    """hash -> key sort -> matcher (with the unsort).  Returns best
    len<<16|dist (B, W) int32 per position (a pair of them when top2)."""
    W = window.shape[1]
    ne, nf = _split_words(nw, fp)
    key, words = _prep(window, ne, hash_bytes, nf)
    skey, order = torch.sort(key, dim=1)
    return _run_matcher(skey, order, words, min_src, limit, W, K, max_dist,
                        nf, top2)


def _score(l: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.where(l >= consts.MIN_MATCH_LEN, (l << SCORE_SHIFT) - d, -1)


def find_matches_fused(window: torch.Tensor, ctx_len: torch.Tensor,
                       valid_len: torch.Tensor, *, K: int, nw: int = 2,
                       ctx: int = CTX, K3: int = 0, fp: bool | int = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best (len, dist) per window position.

    window: (B, W) uint8 = [ctx | shard] rows; ctx_len: valid context bytes
    per row; valid_len: real shard bytes per row (positions beyond
    ctx+valid_len neither match nor serve as sources).  `nw` carry words
    bound the selection length (4*nw bytes); full lengths come from
    same-distance chain extension.  K3 > 0 adds a 3-byte-hash pass (K3
    candidates, dist <= 4096).  fp ranks candidates over the 4*nw bytes
    by fingerprints but emits exact lengths capped at 4*ne bytes
    (_split_words); the top-2 chain extension then recovers full lengths
    even where the next position's best candidate has another distance.
    No level sets it.  Returns (mlen, mdist) int32 (B, W)."""
    min_src = (ctx - ctx_len.to(torch.int32)).to(torch.int32)
    limit = (ctx + valid_len.to(torch.int32)).to(torch.int32)
    cap = 4 * _split_words(nw, fp)[0]

    if fp:
        ld, ld2 = _candidate_pass(
            window, min_src, limit, K=K, nw=nw, hash_bytes=4,
            max_dist=consts.MAX_DISTANCE, fp=fp, top2=True)
        mlen, mdist = runs.extend_chains2(
            ld >> 16, ld & 0xFFFF, ld2 >> 16, ld2 & 0xFFFF, limit, cap)
    else:
        ld = _candidate_pass(window, min_src, limit, K=K, nw=nw,
                             hash_bytes=4, max_dist=consts.MAX_DISTANCE)
        mlen = ld >> 16
        mdist = ld & 0xFFFF

    if K3 > 0:
        ld3 = _candidate_pass(window, min_src, limit, K=K3, nw=1,
                              hash_bytes=3, max_dist=4096)
        l3 = torch.clamp(ld3 >> 16, max=3)
        d3 = ld3 & 0xFFFF
        upd3 = _score(l3, d3) > _score(mlen, mdist)
        mlen = torch.where(upd3, l3, mlen)
        mdist = torch.where(upd3, d3, mdist)

    rlen, rdist = runs.small_dist_runs(window, limit, min_src)
    upd = _score(rlen, rdist) > _score(mlen, mdist)
    mlen = torch.where(upd, rlen, mlen).contiguous()
    mdist = torch.where(upd, rdist, mdist).contiguous()

    mlen = runs.extend_chains(mlen, mdist, limit, cap=cap)

    drop = (mlen == consts.MIN_MATCH_LEN) & (mdist > 4096)
    return torch.where(drop, 0, mlen), torch.where(drop, 0, mdist)
