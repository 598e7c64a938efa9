"""Token parse on the device: lazy/greedy decision and token-start walks.

Counterpart of flate_tpu/jx/parse.py: truncate_matches (:191), decide
(:23), _runs_of_ones (:128), parse_blocks (:143), parse_walk (:211, kernel
B9 `_parse_walk_pallas` :89) and parse_doubling (:38).  DEFLATE permits
any valid tokenization, so matches are truncated at fixed block boundaries
and every block's walk is independent.

The walk "mark i, add step[i], until past the row" is one CUDA kernel
(csrc/encode_kernels.cu, B9) for CUDA tensors, with rows = parse blocks
(parse_blocks, squeeze.squeeze_parse) or rows = shards (parse_walk).  Its
plain version beside it advances every row together in a Python loop and
skips literal runs in one hop through a run-length table.
"""

from __future__ import annotations

import torch

from .. import _build, consts

PARSE_BLK = 1024


def decide(mlen: torch.Tensor, mdist: torch.Tensor, lazy: bool,
           max_lazy: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position (take_match, step) under the one-step lazy rule: a
    match is deferred when the next position holds a strictly longer one
    and it is below max_lazy.  Arrays are (B, W)."""
    take = mlen >= consts.MIN_MATCH_LEN
    if lazy:
        nxt = torch.nn.functional.pad(mlen[:, 1:], (0, 1))
        take = take & ~((nxt > mlen) & (mlen < max_lazy))
    step = torch.where(take, torch.clamp(mlen, min=1), 1)
    return take, step


def truncate_matches(mlen: torch.Tensor, mdist: torch.Tensor, start: int,
                     blk: int = PARSE_BLK
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamp match lengths so no match crosses a block boundary at
    start + k*blk; lengths below the minimum become literals."""
    W = mlen.shape[1]
    pos = torch.arange(W, dtype=torch.int32, device=mlen.device)[None, :]
    rel = pos - start
    room = torch.where(rel >= 0, blk - torch.remainder(rel, blk), 1 << 20)
    t = torch.minimum(mlen, room.to(mlen.dtype))
    keep = t >= consts.MIN_MATCH_LEN
    return torch.where(keep, t, 0), torch.where(keep, mdist, 0)


def _runs_of_ones(x: torch.Tensor, limit: int) -> torch.Tensor:
    """cnt[i] = consecutive True starting at i (row-local, saturating)."""
    cnt = x.to(torch.int32)
    step = 1
    while step < limit:
        shifted = torch.nn.functional.pad(cnt[:, step:], (0, step))
        cnt = cnt + torch.where(cnt == step, shifted, 0)
        step *= 2
    return cnt


def _parse_walk_plain(sb: torch.Tensor) -> torch.Tensor:
    """Token-start mask of every row of sb (L, n) steps >= 1, walked from
    0.

    Each iteration advances every unfinished row by one token (or one
    literal run, every position of which is a start) and costs one host
    sync for the loop test.  The visited spans are disjoint per row, so
    they are recorded as +1/-1 marks and summed once at the end."""
    L, n = sb.shape
    dev = sb.device
    run1 = _runs_of_ones(sb == 1, n)
    lanes = torch.arange(L, device=dev)
    cur = torch.zeros(L, dtype=torch.int64, device=dev)
    marks = torch.zeros((L, n + 1), dtype=torch.int32, device=dev)
    while True:
        live = cur < n
        if not bool(live.any()):
            break
        c = torch.where(live, cur, 0)
        s = sb[lanes, c]
        r = run1[lanes, c]
        islit = s == 1
        span = torch.where(islit, r, 1).to(torch.int64)
        one = live.to(torch.int32)
        marks.index_put_((lanes, c), one, accumulate=True)
        marks.index_put_((lanes, torch.where(live, c + span, n)), -one,
                         accumulate=True)
        adv = torch.where(islit, r, torch.clamp(s, min=1)).to(torch.int64)
        cur = torch.where(live, cur + adv, cur)
    return torch.cumsum(marks[:, :n], dim=1) > 0


def _parse_walk(step: torch.Tensor) -> torch.Tensor:
    """Serial token-start walk (kernel B9): step (R, n) int32 jumps >= 1 ->
    (R, n) bool mask of the positions 0, step[0], step[0] + step[step[0]],
    ... of each row."""
    if _build.use_plain(step):
        return _parse_walk_plain(step)
    R, n = step.shape
    _build.check_cuda("parse_walk.step", step, torch.int32, (R, n))
    out = torch.empty((R, n), dtype=torch.bool, device=step.device)
    _build.launch("flate_parse_walk", step.data_ptr(), out.data_ptr(), R, n)
    return out


def parse_blocks(mlen: torch.Tensor, mdist: torch.Tensor, start: int = 0,
                 *, lazy: bool = True, max_lazy: int = 32,
                 blk: int = PARSE_BLK) -> torch.Tensor:
    """Token-start mask via block-local walks; (B, W) -> (B, W) bool.

    Matches are truncated so none crosses a `blk` boundary past `start`
    (the caller must emit tokens under the same rule), so the walk of a
    row restarts at every block: the rows handed to _parse_walk are the
    parse blocks.  The step is decided on whole rows first, because the
    lazy rule looks one position ahead, across a block's end."""
    B, W = mlen.shape
    S = W - start
    if S % blk:
        raise ValueError("shard region must divide into parse blocks")
    mlen, mdist = truncate_matches(mlen, mdist, start, blk)
    _, step = decide(mlen, mdist, lazy, max_lazy)
    sb = step[:, start:].to(torch.int32).reshape(B * (S // blk), blk)
    sb = sb.contiguous()         # a view when the shard is one block
    pad = torch.zeros((B, start), dtype=torch.bool, device=mlen.device)
    return torch.cat([pad, _parse_walk(sb).reshape(B, S)], dim=1)


def parse_walk(mlen: torch.Tensor, mdist: torch.Tensor, start: int = 0, *,
               lazy: bool = True, max_lazy: int = 32) -> torch.Tensor:
    """Token-start mask by one serial walk per row from `start`, over
    untruncated matches; (B, W) -> (B, W) bool.  Same output contract as
    parse_doubling."""
    B = mlen.shape[0]
    _, step = decide(mlen, mdist, lazy, max_lazy)
    sub = step[:, start:].to(torch.int32).contiguous()
    pad = torch.zeros((B, start), dtype=torch.bool, device=mlen.device)
    return torch.cat([pad, _parse_walk(sub)], dim=1)


def parse_doubling(mlen: torch.Tensor, mdist: torch.Tensor, start: int = 0,
                   *, lazy: bool = True, max_lazy: int = 32) -> torch.Tensor:
    """Token-start mask via pointer doubling: log2(W) rounds of a gather
    and a scatter; (B, W) -> (B, W) bool."""
    B, N = mlen.shape
    dev = mlen.device
    _, step = decide(mlen, mdist, lazy, max_lazy)
    idx = torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    nxt = torch.clamp(idx + step.to(torch.int64), max=N)
    nxt = torch.where(idx < start, torch.clamp(idx + 1, max=N), nxt)
    on = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    on[:, start] = True
    jump = torch.cat([nxt, torch.full((B, 1), N, dtype=torch.int64,
                                      device=dev)], dim=1)
    for _ in range(max(1, (N - 1).bit_length())):
        hits = torch.where(on[:, :-1], jump[:, :-1], N)
        on = on.scatter(1, hits, True)       # column N is the sink
        jump = torch.gather(jump, 1, jump)
    return on[:, :N] & (idx >= start)
