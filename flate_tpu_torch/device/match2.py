"""LZ77 match search: sorted-neighbour candidate scan.

Counterpart of flate_tpu/jx/match2.py:find_matches_fused (:365),
including the opt-in fingerprint-ranked scan (fp=True) with its top-2
chain extension.  Positions are sorted by (14-bit hash of the next bytes, pos);
after sorting, the K most recent same-hash predecessors of a position are
the K previous rows.  Any candidate that passes the byte comparison is a
valid back-reference, so bucket collisions are harmless.

The TPU carries the window words through its sort because gathers
scalarize there.  Keys are unique (pos sits in the low 18 bits), so here a
key-only torch.sort gives the identical order, the matcher builds the
exact words of each sorted row from the window bytes (`_window_words`),
B1 writes only the keys and the fingerprint words, and the unsort is an
inverse-permutation scatter (fused into the CUDA matcher).  A key is
stored as int32 `sort_key(key)` = u32 key ^ 0x80000000: a signed sort of
it is the u32 order (PyTorch's CUDA sort takes no uint32), at half the
bytes of an int64 key; `key_u32` turns it back.

Kernels (csrc/encode_kernels.cu): B1 `_prep`, B2 `_run_matcher`.
"""

from __future__ import annotations

import torch

from .. import _build, consts, metrics
from . import runs, to_i32

CTX = consts.MAX_DISTANCE        # context bytes prepended to each shard
SCORE_SHIFT = 16                 # score = (len << 16) - dist; dist <= 32768
TILE = 8192                      # key rows are padded to a multiple of this
POS_BITS = 18                    # window <= 256 KiB positions
POS_MASK = (1 << POS_BITS) - 1
HASH_BITS = 32 - POS_BITS        # 14-bit buckets
SENTINEL = 0xFFFFFFFF            # the u32 key of a pad position: sorts last
KEY_FLIP = 0x80000000            # stored key = u32 key ^ KEY_FLIP, as int32
_M32 = 0xFFFFFFFF
FP_MUL = 0x01000193              # FNV prime: the fingerprint polynomial


def _mul_u32(v: torch.Tensor, m: int) -> torch.Tensor:
    """(v * m) mod 2**32 for u32 values in int64, without int64 overflow:
    the multiplier is split into 16-bit halves."""
    lo = v * (m & 0xFFFF)
    hi = ((v * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def sort_key(key: torch.Tensor) -> torch.Tensor:
    """u32 keys (int64) -> the int32 keys B1 stores: key ^ 0x80000000 as
    a bit pattern, whose signed order is the u32 order."""
    return to_i32(key ^ KEY_FLIP)


def key_u32(stored: torch.Tensor) -> torch.Tensor:
    """B1's stored int32 keys -> the u32 keys (int64): the inverse of
    `sort_key`."""
    return (stored.to(torch.int64) & _M32) ^ KEY_FLIP


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
# B1: prep — sort keys and fingerprint words
# ---------------------------------------------------------------------------

def _prep_plain(window: torch.Tensor, ne: int, hash_bytes: int, nf: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    B, W = window.shape
    Wp = -(-W // TILE) * TILE
    nbytes = max(4 * ne << nf if nf else 0, hash_bytes)
    wpad = torch.nn.functional.pad(window.to(torch.int64),
                                   (0, Wp - W + nbytes))
    planes = [wpad[:, j:j + Wp] for j in range(nbytes)]

    def le_word(w):
        return (planes[4 * w] | (planes[4 * w + 1] << 8)
                | (planes[4 * w + 2] << 16) | (planes[4 * w + 3] << 24))

    words = []
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
    key = sort_key(torch.where(pos < W, (h << POS_BITS) | pos, SENTINEL))
    if not words:
        return key, torch.empty((B, 0, Wp), dtype=torch.int32,
                                device=window.device)
    return key, torch.stack(words, dim=1)


def _prep(window: torch.Tensor, ne: int, hash_bytes: int, nf: int = 0
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """window (B, W) uint8 -> (key (B, Wp) int32 `sort_key`s of the u32
    keys, fps (B, nf, Wp) int32 u32 bit patterns: the FNV fingerprints of
    the spans that follow the ne exact words), Wp = W rounded up to TILE.
    The exact words are not written: the matcher builds them from the
    window."""
    if _build.use_plain(window):
        return _prep_plain(window, ne, hash_bytes, nf)
    B, W = window.shape
    Wp = -(-W // TILE) * TILE
    _build.check_cuda("prep.window", window, torch.uint8, (B, W))
    if not 1 <= hash_bytes <= 4:
        raise ValueError(f"hash_bytes must be 1..4, got {hash_bytes}")
    key = torch.empty((B, Wp), dtype=torch.int32, device=window.device)
    words = torch.empty((B, nf, Wp), dtype=torch.int32,
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


def _window_words(window: torch.Tensor, pos: torch.Tensor, ne: int,
                  hash_bytes: int) -> torch.Tensor:
    """The ne carry words of positions `pos` (B, P) as B2's kernel builds
    them from the window (B, W): the row as little-endian u32 words, zero
    past W (padded to a multiple of 4), and word t of pos the funnel shift
    of the two aligned words under pos + 4t; word 0 masked to hash_bytes
    bytes in the 3-byte pass.  Returns (B, ne, P) int64 u32 values: the
    carry words the TPU kernel's prep writes, at those positions."""
    B, W = window.shape
    Ww = -(-W // 4) * 4
    row = torch.nn.functional.pad(window.to(torch.int64), (0, Ww - W))
    row = row.reshape(B, Ww // 4, 4)
    aligned = (row[..., 0] | (row[..., 1] << 8) | (row[..., 2] << 16)
               | (row[..., 3] << 24))
    aligned = torch.nn.functional.pad(aligned, (0, 1))     # zero past W
    nw4 = Ww // 4
    out = []
    for t in range(ne):
        a = pos.to(torch.int64) + 4 * t
        w0 = torch.clamp(a >> 2, max=nw4)
        lo = torch.gather(aligned, 1, w0)
        hi = torch.gather(aligned, 1, torch.clamp(w0 + 1, max=nw4))
        sh = (a & 3) * 8
        v = ((lo >> sh) | (hi << (32 - sh))) & _M32
        if t == 0 and hash_bytes < 4:
            v = v & ((1 << (8 * hash_bytes)) - 1)
        out.append(v)
    return torch.stack(out, dim=1)


def _candidates(skey: torch.Tensor, order: torch.Tensor,
                window: torch.Tensor, fps: torch.Tensor,
                min_src: torch.Tensor, limit: torch.Tensor, K: int,
                max_dist: int, ne: int, hash_bytes: int = 4,
                stats: dict | None = None):
    """The K candidates of every sorted row (skey as B1 stores it) as
    whole-row shifts: yields, for d = 1..K, (score, ld) (B, Wp) int32 —
    score = (est<<16) - dist of the candidate d rows back, or -1 where it
    is no match of len >= 3, and ld = len<<16 | dist.  With `stats`, also
    counts what the data asks of any scan (set when the generator ends).
    Going back within a bucket the positions fall, so a scan may end at the
    first candidate of another bucket, past max_dist or below min_src, and
    a row with fewer than 3 bytes before its limit needs no scan:
    stats["visits"] counts the candidates within K before that end in the
    rows that need one (a few tests each), stats["compares"] the word
    compares of their valid candidates, one per exact word up to and
    including the first that differs and one per fingerprint word
    likewise."""
    B, Wp = skey.shape
    nf = fps.shape[1]
    cap = 4 * ne
    skey = key_u32(skey)
    tpos = (skey & POS_MASK).to(torch.int32)
    tbucket = skey >> POS_BITS
    # words in sorted order: the exact ones from the window, then B1's
    # fingerprints
    tw = list(_window_words(window, order, ne, hash_bytes).unbind(1))
    tw += [torch.gather(fps[:, j].to(torch.int64) & _M32, 1, order)
           for j in range(nf)]
    ms = min_src.to(torch.int32)[:, None]
    lim = limit.to(torch.int32)[:, None]
    maxlen = torch.clamp(lim - tpos, max=consts.MAX_MATCH_LEN)
    scanned = (skey != SENTINEL) & (maxlen >= consts.MIN_MATCH_LEN)

    def back(x, d, fill):
        return torch.nn.functional.pad(x[:, :Wp - d], (d, 0), value=fill)

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
            visits += ((ck >> POS_BITS == tbucket) & (dist <= max_dist)
                       & (cpos >= ms) & scanned).sum()
        for t in range(ne):
            if stats is not None:
                compares += (valid & run & scanned).sum()
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
                compares += (valid & fp_run & scanned).sum()
            fp_run = fp_run & (tw[ne + j] == back(tw[ne + j], d, 0))
            est = est + torch.where(fp_run, cap << j, 0)
        ok = valid & (ml >= consts.MIN_MATCH_LEN)
        yield torch.where(ok, (est << 16) - dist, -1), (ml << 16) | dist
    if stats is not None:
        stats["visits"] = int(visits)
        stats["compares"] = int(compares)


def _unsort(x: torch.Tensor, order: torch.Tensor, W: int) -> torch.Tensor:
    """Sorted rows back to position order: order is a permutation of
    [0, Wp); rows of pad positions land at >= W and are cut."""
    return torch.empty_like(x).scatter_(1, order, x)[:, :W]


def _run_matcher_plain(skey: torch.Tensor, order: torch.Tensor,
                       window: torch.Tensor, fps: torch.Tensor,
                       min_src: torch.Tensor, limit: torch.Tensor, W: int,
                       K: int, max_dist: int, ne: int, hash_bytes: int = 4,
                       top2: bool = False, stats: dict | None = None):
    """The scan over `_candidates` in order d = 1..K, keeping the best
    score and, with top2, the runner-up (a new best demotes the old one,
    otherwise a candidate above the runner-up replaces it).  Scores of one
    row are distinct (each candidate has its own distance), so these are
    the two largest whatever the order.  `stats` as in `_candidates`."""
    B, Wp = skey.shape

    def blank(fill):
        return torch.full((B, Wp), fill, dtype=torch.int32,
                          device=skey.device)

    best_score, best_ld = blank(-1), blank(0)
    sec_score, sec_ld = blank(-1), blank(0)
    for score, ld in _candidates(skey, order, window, fps, min_src, limit, K,
                                 max_dist, ne, hash_bytes, stats):
        upd = score > best_score
        if top2:
            upd2 = ~upd & (score > sec_score)
            sec_score = torch.where(upd, best_score,
                                    torch.where(upd2, score, sec_score))
            sec_ld = torch.where(upd, best_ld,
                                 torch.where(upd2, ld, sec_ld))
        best_score = torch.where(upd, score, best_score)
        best_ld = torch.where(upd, ld, best_ld)
    if top2:
        return _unsort(best_ld, order, W), _unsort(sec_ld, order, W)
    return _unsort(best_ld, order, W)


def _run_matcher(skey: torch.Tensor, order: torch.Tensor,
                 window: torch.Tensor, fps: torch.Tensor,
                 min_src: torch.Tensor, limit: torch.Tensor, W: int, K: int,
                 max_dist: int, ne: int, hash_bytes: int = 4,
                 top2: bool = False):
    """skey (B, Wp) int32 sorted keys as B1 stores them (`sort_key`),
    order (B, Wp) their positions, window (B, W) uint8, fps (B, nf, Wp)
    int32 B1's fingerprint words by position (they rank only); ne exact
    words, made from the window with `hash_bytes` (`_window_words`).
    Returns best len<<16|dist (B, W) int32 in position order, and the
    runner-up beside it when top2."""
    if _build.use_plain(skey):
        return _run_matcher_plain(skey, order, window, fps, min_src, limit,
                                  W, K, max_dist, ne, hash_bytes, top2)
    B, Wp = skey.shape
    nf = fps.shape[1]
    min_src = min_src.to(torch.int32).contiguous()
    limit = limit.to(torch.int32).contiguous()
    _build.check_cuda("matcher.skey", skey, torch.int32, (B, Wp))
    _build.check_cuda("matcher.window", window, torch.uint8, (B, W))
    _build.check_cuda("matcher.fps", fps, torch.int32, (B, nf, Wp))
    _build.check_cuda("matcher.min_src", min_src, torch.int32, (B,))
    _build.check_cuda("matcher.limit", limit, torch.int32, (B,))
    if W > Wp or Wp > (1 << POS_BITS) - 1:
        raise ValueError(f"window {W} exceeds the {POS_BITS}-bit positions")
    if ne < 1:
        raise ValueError(f"ne must be >= 1, got {ne}")
    if hash_bytes not in (3, 4):
        raise ValueError(f"hash_bytes must be 3 or 4, got {hash_bytes}")
    # the kernel reads each row as u32 words: pad it to a multiple of 4
    # with zeros (the bytes past W are zero to the words too)
    Ww = -(-W // 4) * 4
    if Ww != W or window.data_ptr() % 4:
        window = torch.nn.functional.pad(window, (0, Ww - W))
    out = torch.empty((B, W), dtype=torch.int32, device=skey.device)
    out2 = torch.empty_like(out) if top2 else None
    _build.launch("flate_matcher", skey.data_ptr(), window.data_ptr(),
                  fps.data_ptr(), min_src.data_ptr(), limit.data_ptr(),
                  out.data_ptr(), out2.data_ptr() if top2 else None,
                  B, W, Ww, Wp, ne, nf, K, max_dist, hash_bytes)
    return (out, out2) if top2 else out


def _candidate_pass(window: torch.Tensor, min_src: torch.Tensor,
                    limit: torch.Tensor, *, K: int, nw: int,
                    hash_bytes: int, max_dist: int, fp: bool | int = False,
                    top2: bool = False):
    """hash -> key sort -> matcher (with the unsort).  Returns best
    len<<16|dist (B, W) int32 per position (a pair of them when top2)."""
    W = window.shape[1]
    ne, nf = _split_words(nw, fp)
    key, fps = _prep(window, ne, hash_bytes, nf)
    skey, order = torch.sort(key, dim=1)
    return _run_matcher(skey, order, window, fps, min_src, limit, W, K,
                        max_dist, ne, hash_bytes, top2)


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
    No level sets it.  Returns (mlen, mdist) int32 (B, W).

    Its passes are spans inside the caller's encode.match (metrics.span):
    encode.match.main, encode.match.k3 (K3 > 0 only) and
    encode.match.extend (the small-distance runs, the chain extension and
    the drop of far 3-byte matches)."""
    min_src = (ctx - ctx_len.to(torch.int32)).to(torch.int32)
    limit = (ctx + valid_len.to(torch.int32)).to(torch.int32)
    cap = 4 * _split_words(nw, fp)[0]

    with metrics.span("encode.match.main"):
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
        with metrics.span("encode.match.k3"):
            ld3 = _candidate_pass(window, min_src, limit, K=K3, nw=1,
                                  hash_bytes=3, max_dist=4096)
            l3 = torch.clamp(ld3 >> 16, max=3)
            d3 = ld3 & 0xFFFF
            upd3 = _score(l3, d3) > _score(mlen, mdist)
            mlen = torch.where(upd3, l3, mlen)
            mdist = torch.where(upd3, d3, mdist)

    with metrics.span("encode.match.extend"):
        rlen, rdist = runs.small_dist_runs(window, limit, min_src)
        upd = _score(rlen, rdist) > _score(mlen, mdist)
        mlen = torch.where(upd, rlen, mlen).contiguous()
        mdist = torch.where(upd, rdist, mdist).contiguous()

        mlen = runs.extend_chains(mlen, mdist, limit, cap=cap)

        drop = (mlen == consts.MIN_MATCH_LEN) & (mdist > 4096)
        return torch.where(drop, 0, mlen), torch.where(drop, 0, mdist)
