"""Run-length helpers of the matcher: small-distance runs and same-distance
chain extension.

Counterparts of flate_tpu/jx/runs.py:small_dist_runs (:119),
extend_chains (:296) and extend_chains2 (:269).  Each wrapper launches its
CUDA kernel (csrc/encode_kernels.cu, B3, B4 and B8) for CUDA tensors and
runs the plain PyTorch version beside it for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build, consts

SMALL_DISTS = (1, 2, 3, 4, 8)
SCORE_SHIFT = 16


def _fwd(x: torch.Tensor, j: int) -> torch.Tensor:
    """x[:, p + j] with zeros past the end."""
    return torch.nn.functional.pad(x[:, j:], (0, j))


def _maxlen(limit: torch.Tensor, W: int, device) -> torch.Tensor:
    pos = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    return torch.clamp(limit.to(torch.int32)[:, None] - pos, 0,
                       consts.MAX_MATCH_LEN)


# ---------------------------------------------------------------------------
# small-distance runs (kernel B3)
# ---------------------------------------------------------------------------

def _run_lengths(window: torch.Tensor, limit: torch.Tensor,
                 min_src: torch.Tensor) -> list[torch.Tensor]:
    """Per d in SMALL_DISTS, the clamped forward run of w[x] == w[x-d]
    (B, W) int32, by saturating run-length doubling as the TPU kernel
    counts: after the round of step s, cnt = min(run, 2s); the clamps make
    it exact."""
    W = window.shape[1]
    w = window.to(torch.int32)
    pos = torch.arange(W, dtype=torch.int32, device=window.device)[None, :]
    maxlen = _maxlen(limit, W, window.device)
    out = []
    for d in SMALL_DISTS:
        prev = torch.nn.functional.pad(w[:, :W - d], (d, 0))   # w[x - d]
        cnt = ((w == prev) & (pos >= min_src.to(torch.int32)[:, None] + d)
               ).to(torch.int32)
        step = 1
        while step <= consts.MAX_MATCH_LEN:
            cnt = cnt + torch.where(cnt == step, _fwd(cnt, step), 0)
            step *= 2
        out.append(torch.minimum(torch.clamp(cnt, max=consts.MAX_MATCH_LEN),
                                 maxlen))
    return out


def _small_dist_runs_plain(window: torch.Tensor, limit: torch.Tensor,
                           min_src: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    B, W = window.shape
    best_len = torch.zeros((B, W), dtype=torch.int32, device=window.device)
    best_dist = torch.zeros_like(best_len)
    for d, ln in zip(SMALL_DISTS, _run_lengths(window, limit, min_src)):
        score_new = (ln << SCORE_SHIFT) - d
        score_old = (best_len << SCORE_SHIFT) - best_dist
        upd = (ln >= consts.MIN_MATCH_LEN) & \
            ((best_len == 0) | (score_new > score_old))
        best_len = torch.where(upd, ln, best_len)
        best_dist = torch.where(upd, d, best_dist)
    return best_len, best_dist


def small_dist_runs(window: torch.Tensor, limit: torch.Tensor,
                    min_src: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """window (B, W) uint8; limit (B,) = first invalid position; min_src
    (B,) = first valid source.  Returns (best_len, best_dist) (B, W) int32."""
    if _build.use_plain(window):
        return _small_dist_runs_plain(window, limit, min_src)
    B, W = window.shape
    limit = limit.to(torch.int32).contiguous()
    min_src = min_src.to(torch.int32).contiguous()
    _build.check_cuda("small_dist_runs.window", window, torch.uint8, (B, W))
    _build.check_cuda("small_dist_runs.limit", limit, torch.int32, (B,))
    _build.check_cuda("small_dist_runs.min_src", min_src, torch.int32, (B,))
    out_len = torch.empty((B, W), dtype=torch.int32, device=window.device)
    out_dist = torch.empty_like(out_len)
    _build.launch("flate_small_runs", window.data_ptr(), limit.data_ptr(),
                  min_src.data_ptr(), out_len.data_ptr(), out_dist.data_ptr(),
                  B, W)
    return out_len, out_dist


# ---------------------------------------------------------------------------
# same-distance chain extension (kernel B4)
# ---------------------------------------------------------------------------

def _extend_chains_plain(mlen: torch.Tensor, mdist: torch.Tensor,
                         limit: torch.Tensor, cap: int) -> torch.Tensor:
    """Rounds of total = chain ? min(cap + total[p+cap], 516) : len, as
    the TPU kernel composes them."""
    B, W = mlen.shape
    l = mlen.to(torch.int32)
    d = mdist.to(torch.int32)
    chain = (l == cap) & (_fwd(d, cap) == d) & (d > 0)
    total = l
    rounds = -(-consts.MAX_MATCH_LEN // cap) + 1
    for _ in range(rounds):
        total = torch.where(
            chain,
            torch.clamp(cap + _fwd(total, cap), max=2 * consts.MAX_MATCH_LEN),
            l)
    return torch.minimum(torch.clamp(total, max=consts.MAX_MATCH_LEN),
                         _maxlen(limit, W, mlen.device))


def extend_chains(mlen: torch.Tensor, mdist: torch.Tensor,
                  limit: torch.Tensor, cap: int) -> torch.Tensor:
    """Extend cap-saturated matches through same-distance continuations.
    mlen, mdist (B, W) int32; limit (B,).  Returns (B, W) int32."""
    if _build.use_plain(mlen):
        return _extend_chains_plain(mlen, mdist, limit, cap)
    B, W = mlen.shape
    limit = limit.to(torch.int32).contiguous()
    _build.check_cuda("extend_chains.mlen", mlen, torch.int32, (B, W))
    _build.check_cuda("extend_chains.mdist", mdist, torch.int32, (B, W))
    _build.check_cuda("extend_chains.limit", limit, torch.int32, (B,))
    out = torch.empty_like(mlen)
    _build.launch("flate_extend", mlen.data_ptr(), mdist.data_ptr(),
                  limit.data_ptr(), out.data_ptr(), B, W, cap)
    return out


# ---------------------------------------------------------------------------
# top-2 same-distance chain extension (kernel B8)
# ---------------------------------------------------------------------------

def _extend_chains2_plain(l1: torch.Tensor, d1: torch.Tensor,
                          l2: torch.Tensor, d2: torch.Tensor,
                          limit: torch.Tensor, cap: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rounds of t = chain ? min(cap + t[p+cap], 516) : len over both
    candidates, with whole-row shifts, as the TPU kernel composes them."""
    W = l1.shape[1]
    l1, d1, l2, d2 = (x.to(torch.int32) for x in (l1, d1, l2, d2))
    nd1, nd2 = _fwd(d1, cap), _fwd(d2, cap)
    c1a = (l1 == cap) & (nd1 == d1) & (d1 > 0)
    c1b = (l1 == cap) & ~c1a & (nd2 == d1) & (d1 > 0)
    c2a = (l2 == cap) & (nd1 == d2) & (d2 > 0)
    c2b = (l2 == cap) & ~c2a & (nd2 == d2) & (d2 > 0)
    t1, t2 = l1, l2
    rounds = -(-consts.MAX_MATCH_LEN // cap) + 1
    for _ in range(rounds):
        v1 = torch.clamp(cap + _fwd(t1, cap), max=2 * consts.MAX_MATCH_LEN)
        v2 = torch.clamp(cap + _fwd(t2, cap), max=2 * consts.MAX_MATCH_LEN)
        t1 = torch.where(c1a, v1, torch.where(c1b, v2, l1))
        t2 = torch.where(c2a, v1, torch.where(c2b, v2, l2))
    maxlen = _maxlen(limit, W, l1.device)
    t1 = torch.minimum(torch.clamp(t1, max=consts.MAX_MATCH_LEN), maxlen)
    t2 = torch.minimum(torch.clamp(t2, max=consts.MAX_MATCH_LEN), maxlen)
    s1 = torch.where(t1 >= consts.MIN_MATCH_LEN, (t1 << SCORE_SHIFT) - d1, -1)
    s2 = torch.where(t2 >= consts.MIN_MATCH_LEN, (t2 << SCORE_SHIFT) - d2, -1)
    pick2 = s2 > s1
    out_l = torch.where(pick2, t2, t1)
    out_d = torch.where(pick2, d2, d1)
    # the maxlen clip can shorten tail matches below the minimum: drop them
    live = out_l >= consts.MIN_MATCH_LEN
    return torch.where(live, out_l, 0), torch.where(live, out_d, 0)


def extend_chains2(l1: torch.Tensor, d1: torch.Tensor, l2: torch.Tensor,
                   d2: torch.Tensor, limit: torch.Tensor, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-2 chain extension: a cap-saturated candidate at p with distance
    d continues through p+cap when either of p+cap's two candidates has
    distance d.  l1, d1, l2, d2 (B, W) int32 (best and runner-up per
    position); limit (B,).  Returns (mlen, mdist) (B, W) int32: the better
    of the two extended candidates."""
    if _build.use_plain(l1):
        return _extend_chains2_plain(l1, d1, l2, d2, limit, cap)
    B, W = l1.shape
    limit = limit.to(torch.int32).contiguous()
    ins = (l1, d1, l2, d2)
    for name, x in zip(("l1", "d1", "l2", "d2"), ins):
        _build.check_cuda(f"extend_chains2.{name}", x, torch.int32, (B, W))
    _build.check_cuda("extend_chains2.limit", limit, torch.int32, (B,))
    out_len = torch.empty((B, W), dtype=torch.int32, device=l1.device)
    out_dist = torch.empty_like(out_len)
    _build.launch("flate_extend2", *(x.data_ptr() for x in ins),
                  limit.data_ptr(), out_len.data_ptr(), out_dist.data_ptr(),
                  B, W, cap)
    return out_len, out_dist
