"""Length-limited Huffman planning on the device — batched package-merge.

Counterpart of flate_tpu/jx/huff.py: pm_lengths (:48),
canonical_codes_dev (:117), packed_tables (:141) and coded_size (:147).
Fixed-shape arrays: lists padded to 2n with +INF sentinels; each level's
merge of sorted symbols with sorted packages is one sort over keys
(weight << 1 | is_package), so original symbols win weight ties.
"""

from __future__ import annotations

import torch

INF = 1 << 21                     # weights stay below this (< 2^18 in use)
SYM_BITS = 9                      # alphabet <= 512 (largest is 286)


def _take1(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b] = arr[b, idx[b]]."""
    return torch.gather(arr, 1, idx[:, None])[:, 0]


def pm_lengths(freq: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Optimal length-limited code lengths, batched.

    freq (B, n) frequencies (0 = unused).  Returns (B, n) int64 lengths
    (0 for unused; <= max_bits)."""
    B, n = freq.shape
    dev = freq.device
    freq = freq.to(torch.int64)
    active = freq > 0
    nact = active.sum(dim=1)

    sym = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    w = torch.where(active, freq, INF)
    skey = torch.sort((w << SYM_BITS) | sym, dim=1).values
    ws = skey >> SYM_BITS                       # sorted weights, INF tail
    ssym = skey & ((1 << SYM_BITS) - 1)         # symbol of each rank

    # forward: build lists, keep per-level original-prefix counts
    lw = torch.cat([ws, torch.full((B, n), INF, dtype=torch.int64,
                                   device=dev)], dim=1)
    lorig = torch.cat([torch.ones((B, n), dtype=torch.int64, device=dev),
                       torch.zeros((B, n), dtype=torch.int64, device=dev)],
                      dim=1)
    prefixes = [torch.cumsum(lorig, dim=1)]
    for _level in range(2, max_bits + 1):
        pk = torch.clamp(lw[:, 0::2] + lw[:, 1::2], max=INF)
        merged = torch.sort(torch.cat([ws << 1, (pk << 1) | 1], dim=1),
                            dim=1).values
        lw = merged >> 1
        lorig = 1 - (merged & 1)
        prefixes.append(torch.cumsum(lorig, dim=1))

    # backward: taken-original counts per level
    m = torch.clamp(2 * (nact - 1), min=0)
    o_levels = []
    for level in range(max_bits, 1, -1):
        pre = prefixes[level - 1]
        o = torch.where(m > 0, _take1(pre, torch.clamp(m - 1, min=0)), 0)
        o_levels.append(o)
        m = 2 * (m - o)
    o_levels.append(torch.minimum(m, nact))     # level 1: all originals

    rank = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    len_by_rank = torch.zeros((B, n), dtype=torch.int64, device=dev)
    for o in o_levels:
        len_by_rank = len_by_rank + (rank < o[:, None]).to(torch.int64)

    lens = torch.zeros((B, n), dtype=torch.int64, device=dev).scatter_(
        1, ssym, len_by_rank)
    # single active symbol gets length 1; none -> all zero
    lens = torch.where((nact == 1)[:, None], active.to(torch.int64), lens)
    return torch.where(active, lens, 0)


def _rev16(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse 16-bit values."""
    x = ((x & 0x5555) << 1) | ((x & 0xAAAA) >> 1)
    x = ((x & 0x3333) << 2) | ((x & 0xCCCC) >> 2)
    x = ((x & 0x0F0F) << 4) | ((x & 0xF0F0) >> 4)
    return ((x & 0x00FF) << 8) | ((x & 0xFF00) >> 8)


def canonical_codes_dev(lens: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Canonical codes from lengths (RFC 1951 §3.2.2), bit-reversed for
    LSB-first emission.  lens (B, n) -> (B, n) int64."""
    B, n = lens.shape
    lens = lens.to(torch.int64)
    code = torch.zeros(B, dtype=torch.int64, device=lens.device)
    codes = torch.zeros((B, n), dtype=torch.int64, device=lens.device)
    prev_count = torch.zeros(B, dtype=torch.int64, device=lens.device)
    for l in range(1, max_bits + 1):
        mask = lens == l
        code = (code + prev_count) << 1
        cum = torch.cumsum(mask.to(torch.int64), dim=1)
        rank = cum - mask.to(torch.int64)        # rank within length class
        codes = torch.where(mask, code[:, None] + rank, codes)
        prev_count = cum[:, -1]
    rev = _rev16(codes & 0xFFFF)
    shift = 16 - torch.clamp(lens, min=1)
    return torch.where(lens > 0, rev >> shift, 0)


def packed_tables(lens: torch.Tensor, max_bits: int) -> torch.Tensor:
    """code | (len << 24) per symbol, int64: the packer's table entry
    format."""
    lens = lens.to(torch.int64)
    return canonical_codes_dev(lens, max_bits) | (lens << 24)


def coded_size(freq: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(B,) total payload bits when coding freq rows with lens rows."""
    return torch.sum(freq.to(torch.int64) * lens.to(torch.int64), dim=1)
