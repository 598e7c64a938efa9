"""Dynamic-block header construction on the device — position-parallel RLE.

Counterpart of flate_tpu/jx/header.py:build_headers (:130).  Builds, for
a batch of shards, the (value, nbits) fields of a DEFLATE dynamic header:
HLIT/HDIST/HCLEN, the codegen code lengths in CODEGEN_ORDER, and the RLE
items (RFC 1951 §3.2.7 codes 0-15/16/17/18 with extras) coding the
literal/length and distance code lengths.  Runs never cross the hlit
boundary (the section id is part of the run key).
"""

from __future__ import annotations

import functools

import torch

from .. import consts
from . import huff

SEQ = consts.NUM_LITLEN + consts.NUM_DIST          # 316
HDR_SLOTS = 23 + 2 * SEQ                           # 655
BIG = 1 << 20


def _rle_emit(v: torch.Tensor, live: torch.Tensor):
    """Codegen RLE over (B, SEQ) code lengths v; dead positions break runs
    and emit nothing.  Returns (sym, extra_val, extra_bits, emit_mask)."""
    B, n = v.shape
    dev = v.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)[None, :].expand(B, n)
    sec = (idx >= consts.NUM_LITLEN).to(torch.int64)
    key = torch.where(live, v + 16 * sec, -1 - idx)   # dead: unique key
    prev = torch.nn.functional.pad(key[:, :-1], (1, 0), value=-99)
    bnd = key != prev
    start = torch.cummax(torch.where(bnd, idx, -1), dim=1).values
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(bnd, idx, BIG), [1]),
                                  dim=1).values, [1])
    nxt_b = torch.nn.functional.pad(nxt[:, 1:], (0, 1), value=BIG)
    end = torch.clamp(nxt_b, max=n)
    r = end - start                                  # run length
    o = idx - start                                  # offset within run

    is_zero = v == 0
    # zero runs: chunks of 18s, then 17 or literal zeros
    q = r // 138
    s = r - 138 * q
    c18 = q + (s >= 11).to(torch.int64)
    tail = torch.where(s >= 11, 0, s)
    chunk = o // 138
    at_chunk = (o % 138 == 0) & (chunk < c18)
    sz18 = torch.clamp(r - o, max=138)
    z_tail_start = 138 * q + torch.where(s >= 11, s, 0)
    emit17 = (tail >= 3) & (o == z_tail_start)
    lit0 = (tail < 3) & (o >= z_tail_start)

    # nonzero runs: literal first, chunks of 16s, then literal leftovers
    rem = r - 1
    q2 = rem // 6
    s2 = rem - 6 * q2
    c16 = q2 + (s2 >= 3).to(torch.int64)
    tail2 = torch.where(s2 >= 3, 0, s2)
    o2 = o - 1
    at16 = (o >= 1) & (torch.remainder(o2, 6) == 0) \
        & (torch.div(o2, 6, rounding_mode="floor") < c16)
    sz16 = torch.clamp(r - o, max=6)
    nz_tail_start = 1 + 6 * q2 + torch.where(s2 >= 3, s2, 0)
    litv = (o == 0) | ((tail2 > 0) & (o >= nz_tail_start))

    sym = torch.where(
        is_zero,
        torch.where(at_chunk, 18, torch.where(emit17, 17, 0)),
        torch.where(at16, 16, v))
    ev = torch.where(
        is_zero,
        torch.where(at_chunk, sz18 - 11, torch.where(emit17, tail - 3, 0)),
        torch.where(at16, sz16 - 3, 0))
    eb = torch.where(
        is_zero,
        torch.where(at_chunk, 7, torch.where(emit17, 3, 0)),
        torch.where(at16, 2, 0))
    emit = live & torch.where(is_zero, at_chunk | emit17 | lit0, at16 | litv)
    return sym, ev, eb, emit


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """CODEGEN_ORDER and the widths of the four head fields on `device`,
    made once per device so that no call copies from host memory (a CUDA
    graph captures none)."""
    return (torch.tensor(consts.CODEGEN_ORDER, dtype=torch.int64,
                         device=device),
            torch.tensor([[3, 5, 5, 4]], dtype=torch.int64, device=device))


def build_headers(ll_lens: torch.Tensor, d_lens: torch.Tensor,
                  final: torch.Tensor):
    """Dynamic-header fields for a batch.

    ll_lens (B, 286), d_lens (B, 30); final (B,).  Returns (vals (B,
    HDR_SLOTS) int64 u32 values, bits (B, HDR_SLOTS) int64, total_bits
    (B,))."""
    B = ll_lens.shape[0]
    dev = ll_lens.device
    ll_lens = ll_lens.to(torch.int64)
    d_lens = d_lens.to(torch.int64)
    iL = torch.arange(consts.NUM_LITLEN, dtype=torch.int64, device=dev)[None]
    iD = torch.arange(consts.NUM_DIST, dtype=torch.int64, device=dev)[None]
    hlit = torch.clamp(torch.where(ll_lens > 0, iL + 1, 0).amax(dim=1),
                       min=257)
    hdist = torch.clamp(torch.where(d_lens > 0, iD + 1, 0).amax(dim=1), min=1)

    v = torch.cat([ll_lens, d_lens], dim=1)                   # (B, SEQ)
    idx = torch.arange(SEQ, dtype=torch.int64, device=dev)[None]
    live = torch.where(idx < consts.NUM_LITLEN, idx < hlit[:, None],
                       (idx - consts.NUM_LITLEN) < hdist[:, None])
    sym, ev, eb, emit = _rle_emit(v, live)

    cg_freq = torch.zeros((B, consts.NUM_CODEGEN), dtype=torch.int64,
                          device=dev).scatter_add_(1, sym,
                                                   emit.to(torch.int64))
    cg_lens = huff.pm_lengths(cg_freq, consts.MAX_CODEGEN_BITS)
    cg_codes = huff.canonical_codes_dev(cg_lens, consts.MAX_CODEGEN_BITS)

    order, head_bits = _consts(dev)
    ordered = cg_lens[:, order]                               # (B, 19)
    iO = torch.arange(consts.NUM_CODEGEN, dtype=torch.int64, device=dev)[None]
    hclen = torch.clamp(torch.where(ordered > 0, iO + 1, 0).amax(dim=1),
                        min=4)

    item_code = torch.gather(cg_codes, 1, sym)
    item_clen = torch.gather(cg_lens, 1, sym)

    head_vals = torch.stack([final.to(torch.int64) | (2 << 1), hlit - 257,
                             hdist - 1, hclen - 4], dim=1)
    head_bits = head_bits.expand(B, 4)
    cl_bits = torch.where(iO < hclen[:, None], 3, 0)
    item_vals = torch.stack([item_code, ev], dim=2).reshape(B, 2 * SEQ)
    item_bits = torch.where(emit[:, :, None],
                            torch.stack([item_clen, eb], dim=2),
                            0).reshape(B, 2 * SEQ)

    vals = torch.cat([head_vals, ordered, item_vals], dim=1)
    bits = torch.cat([head_bits, cl_bits, item_bits], dim=1)
    return vals, bits, bits.sum(dim=1)
