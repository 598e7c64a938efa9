"""Device optimal-parse squeeze — block-local backward cost DP.

Counterpart of flate_tpu/jx/squeeze.py: greedy_code_lengths (:228),
_entropy_lens (:271) and squeeze_parse (:73).  Within each parse block (no
token crosses a block boundary — the contract of parse.parse_blocks) a
backward DP picks, per position, the cheapest of {literal, the full match
length, a match at one of a coarse grid of lengths}:

    cost[i] = min(lit_bits[i] + cost[i+1],
                  min_l match_bits(l, d_i) + cost[i + l])

Bit costs come from the code lengths of a first greedy pass's token
histogram.  All blocks run as lanes of one tensor; cost[i + l] is read
from a ring of the next WIN costs.  The JAX function is plain XLA (no
Pallas kernel), so this is plain PyTorch on either device; only the final
token-start walk is a kernel (parse._parse_walk, B9).

The options of a step are stacked (O, L) and added to one indexed read of
the ring, so a step is six launches whatever the grid's size.  The JAX
loop tries the options in a fixed order — literal, full length, grid
ascending — and replaces only on a strictly smaller cost, so the first
minimum in that order wins.  Here the order is the low five bits of an
int64 key `cost * 32 + rank`, and one min over the stack gives both.  Costs
stay below 2**28 + 15 * blk, so neither the reference's int32 sums nor
these keys overflow, and the integers are equal.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import consts
from . import encode as enc
from . import huff, onehot
from . import parse as prs

GRID = (3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 258)
WIN = 264                     # ring of future costs (>= 258 + 1)
BIG = 1 << 28
_RANK_BITS = 5                # option rank in the low bits of a DP key


def hist_stride_default() -> int:
    """FLATE_TPU_SQUEEZE_HIST_STRIDE, read when called (default 1)."""
    return int(os.environ.get("FLATE_TPU_SQUEEZE_HIST_STRIDE", "1"))


def grid_only_default() -> bool:
    """FLATE_TPU_SQUEEZE_GRID == "1", read when called."""
    return os.environ.get("FLATE_TPU_SQUEEZE_GRID") == "1"


def _dist_cost(d: torch.Tensor, d_bits: torch.Tensor) -> torch.Tensor:
    dc = enc.dist_code(torch.clamp(d, min=1))
    _, deb = enc.dist_extra(torch.clamp(d, min=1), dc)
    return onehot.lookup_onehot(d_bits.to(torch.int64), dc) + deb


def _match_bits(l: torch.Tensor, d: torch.Tensor, ll_bits: torch.Tensor,
                d_bits: torch.Tensor) -> torch.Tensor:
    """Exact coded size of a (l, d) match under per-row tables.

    l, d: (B, S); ll_bits (B, 286), d_bits (B, 30) code lengths."""
    lc = enc.length_code(torch.clamp(l, min=3))
    _, leb = enc.length_extra(torch.clamp(l, min=3), lc)
    lbits = onehot.lookup_onehot(ll_bits.to(torch.int64), 257 + lc)
    return lbits + leb + _dist_cost(d, d_bits)


def _length_code_py(length: int) -> tuple[int, int]:
    """(code, extra_bits) of a constant length, in host arithmetic."""
    n = length - 3
    if n == 255:
        return 28, 0
    if n < 8:
        return n, 0
    e = max(n.bit_length() - 1 - 2, 1)
    code = (e << 2) + (n >> e)
    return code, (code >> 2) - 1


def _options(grid_only: bool) -> list[tuple[int, int]]:
    """(rank, constant length) of the DP's options in stack order: the
    literal, the grid lengths, then (not grid_only) the full length,
    whose length is per lane (0 here)."""
    sgrid = GRID if grid_only else GRID[:-1]     # 258 comes via full_l
    opts = [(0, 1)] + [(i + 1 + (not grid_only), g)
                       for i, g in enumerate(sgrid)]
    return opts if grid_only else opts + [(1, 0)]


def _heads(blk: int) -> np.ndarray:
    """Ring slot of cost[i+1] at each of the blk + 1 steps."""
    return (-np.arange(blk + 1, dtype=np.int64)) % WIN


@functools.lru_cache(maxsize=None)
def _dp_consts(blk: int, grid_only: bool, device: torch.device):
    """The DP's host-made constants on `device`, made once per device so
    that no call copies from host memory (a CUDA graph captures none):
    len_of (32,) the length of each option rank, slots (blk, NC) the ring
    slot each constant-length option reads at each step, and head_col
    (blk, 1) the head slot at each step."""
    opts = _options(grid_only)
    len_of = np.zeros(1 << _RANK_BITS, dtype=np.int64)
    for rank, g in opts:
        len_of[rank] = g
    const_lens = np.asarray([g for _, g in opts if g], dtype=np.int64)
    heads = _heads(blk)
    slots = (heads[:blk, None] + const_lens[None, :] - 1) % WIN
    return tuple(torch.from_numpy(x).to(device)
                 for x in (len_of, slots, heads[:blk, None].copy()))


def squeeze_parse(window_tail: torch.Tensor, mlen: torch.Tensor,
                  mdist: torch.Tensor, ll_bits: torch.Tensor,
                  d_bits: torch.Tensor, blk: int = 1024,
                  grid_only: bool = False):
    """Cost-optimal (take, starts, sel_len) over the shard region.

    window_tail/mlen/mdist: (B, S) shard-region arrays (matches already
    truncated to parse blocks); ll_bits/d_bits: per-row code lengths from
    the greedy pass.  sel_len is the chosen token length per position
    (literal = 1), int32.  grid_only drops the full-length option: matches
    quantize down to the nearest grid length."""
    B, S = window_tail.shape
    if S % blk:
        raise ValueError("shard region must divide into parse blocks")
    L = B * (S // blk)
    dev = window_tail.device
    i64 = torch.int64
    mlen = mlen.to(i64)
    ll64 = ll_bits.to(i64)

    lit_bits = onehot.lookup_onehot(ll64, window_tail)
    lit_bits = torch.where(lit_bits == 0, 15, lit_bits)    # unseen byte

    dcost = _dist_cost(mdist.to(i64), d_bits)    # shared by every option
    # options as (rank in the DP's order, constant length, cost (B, S));
    # the full-length option (rank 1) has a per-lane length and goes last
    # in the stack, so that the constant-length rows are one range
    if not grid_only:
        has = mlen >= consts.MIN_MATCH_LEN
        full_l = torch.where(has, mlen, 0).reshape(L, blk)
        lc = enc.length_code(torch.clamp(mlen, min=3))
        _, leb = enc.length_extra(torch.clamp(mlen, min=3), lc)
        lbits = onehot.lookup_onehot(ll64, 257 + lc)
        full_c = torch.where(has, lbits + leb + dcost, BIG)
    opts = []
    for rank, g in _options(grid_only):
        if rank == 0:
            cost = lit_bits
        elif g == 0:
            cost = full_c
        else:
            okay = (mlen >= g) if grid_only else (mlen > g)
            gc, geb = _length_code_py(g)
            cost = torch.where(okay, ll64[:, 257 + gc][:, None] + geb + dcost,
                               BIG)
        opts.append((rank, g, cost))
    NC = len(opts) - (not grid_only)             # constant-length rows
    O = len(opts)

    def by_step(x):
        """(B, S) -> (blk, L): row j is position blk-1-j of every block."""
        return x.reshape(L, blk).T.flip(0)

    # keys[j] (O, L) = cost * 32 + rank at step j
    keys = torch.empty((blk, O, L), dtype=i64, device=dev)
    for o, (rank, _, c) in enumerate(opts):
        keys[:, o, :] = by_step((c << _RANK_BITS) + rank)
    len_of, slots, head_col = _dp_consts(blk, grid_only, dev)
    del opts

    # ring (WIN, L) of cost << 5 (beyond the block's end: 0); head h = slot
    # of cost[i+1], the slot of cost[i + l] is (h + l - 1) % WIN, and h
    # steps back once per position
    heads = _heads(blk).tolist()
    if not grid_only:
        full_slot = torch.remainder(head_col + by_step(full_l) - 1,
                                    WIN)                     # (blk, L)
    ring = torch.zeros((WIN, L), dtype=i64, device=dev)
    best = torch.empty((blk, L), dtype=i64, device=dev)     # winning keys
    tot = torch.empty((O, L), dtype=i64, device=dev)
    low = (1 << _RANK_BITS) - 1
    # the loop is bound by the host's time per launch: every view it needs
    # is made before it, in bulk
    ring_rows = ring.unbind(0)
    best_j = best.unbind(0)
    slots_j = slots.unbind(0)
    const_keys, tot_const = keys[:, :NC].unbind(0), tot[:NC]
    if not grid_only:
        full_keys, tot_full = keys[:, NC:].unbind(0), tot[NC:]
        full_slot_j = full_slot.unsqueeze(1).unbind(0)
    for j in range(blk):
        torch.add(const_keys[j], ring.index_select(0, slots_j[j]),
                  out=tot_const)
        if not grid_only:
            torch.add(full_keys[j], ring.gather(0, full_slot_j[j]),
                      out=tot_full)
        torch.amin(tot, dim=0, out=best_j[j])
        torch.bitwise_and(best_j[j], ~low, out=ring_rows[heads[j + 1]])
    del keys

    ranks = (best & low).flip(0).T                          # (L, blk)
    sel = len_of[ranks]
    if not grid_only:
        sel = torch.where(ranks == 1, full_l, sel)
    sel = sel.to(torch.int32).contiguous()

    starts = prs._parse_walk(sel).reshape(B, S)
    sel_pos = sel.reshape(B, S)
    take = starts & (sel_pos >= consts.MIN_MATCH_LEN)
    return take, starts, sel_pos


def greedy_code_lengths(window_tail: torch.Tensor, mlen: torch.Tensor,
                        mdist: torch.Tensor, starts: torch.Tensor,
                        take: torch.Tensor, valid_len: torch.Tensor,
                        exact: bool = False, stride: int | None = None):
    """Code lengths from the greedy pass's token histogram: the DP's cost
    model.  Returns (ll_bits (B, 286), d_bits (B, 30)) int32.

    The DP only ranks parses — emission builds exact tables later — so the
    default is the rounded entropy estimate (-log2 p + 0.35); exact=True
    gives package-merge lengths.  stride > 1 samples every stride-th
    position into the histograms; None reads
    FLATE_TPU_SQUEEZE_HIST_STRIDE when called."""
    if stride is None:
        stride = hist_stride_default()
    valid_len = valid_len.to(torch.int64)
    if stride > 1:
        window_tail = window_tail[:, ::stride]
        mlen, mdist = mlen[:, ::stride], mdist[:, ::stride]
        starts, take = starts[:, ::stride], take[:, ::stride]
        valid_len = -(-valid_len // stride)
    S = window_tail.shape[1]
    dev = window_tail.device
    pos = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    tok_start = starts & (pos < valid_len[:, None])
    is_m = take & tok_start
    lcode = enc.length_code(torch.clamp(mlen, min=3))
    llsym = torch.where(is_m, 257 + lcode, window_tail.to(torch.int64))
    llsym = torch.where(tok_start, llsym, 0)
    dsym = torch.where(is_m, enc.dist_code(torch.clamp(mdist, min=1)), 0)
    hll = onehot.hist_onehot(llsym, tok_start, consts.NUM_LITLEN)
    hll[:, consts.END_OF_BLOCK] += 1
    hdd = onehot.hist_onehot(dsym, is_m, consts.NUM_DIST)
    if exact:
        ll_lens = huff.pm_lengths(hll, consts.MAX_CODE_BITS)
        d_lens = huff.pm_lengths(hdd, consts.MAX_CODE_BITS)
    else:
        ll_lens = torch.round(_entropy_lens(hll))
        d_lens = torch.round(_entropy_lens(hdd))
    # unseen symbols cost a pessimistic 15 bits
    ll_bits = torch.where(ll_lens > 0, ll_lens, 15).to(torch.int32)
    d_bits = torch.where(d_lens > 0, d_lens, 15).to(torch.int32)
    return ll_bits, d_bits


def _entropy_lens(h: torch.Tensor) -> torch.Tensor:
    """-log2(p) + 0.35 clipped to [1, 15], 0 where absent (float32).

    The callers round this to a code length, so a value within an ulp of
    k + 0.5 depends on the library's log2.  p is formed in float32 as the
    reference forms it; log2 is then taken in float64 and rounded to
    float32 once (the correctly rounded float32 log2, the same on the CPU
    and on the card), and the add, clip and half-to-even round are float32
    again."""
    total = torch.clamp(h.sum(dim=1, keepdim=True), min=1).to(torch.float32)
    p = torch.clamp(h.to(torch.float32) / total, min=1e-9)
    lg = torch.log2(p.to(torch.float64)).to(torch.float32)
    bits = torch.clamp(-lg + 0.35, 1.0, 15.0)
    return torch.where(h > 0, bits, 0.0)
