"""Shard stream construction on the device — fields, selection, histograms.

Counterpart of flate_tpu/jx/encode2.py: seg_size, slot_count and
build_fields (:116, compact=False).  Builds per shard the (value, nbits)
field sequence whose LSB-first pack is the byte-aligned shard stream:

    [block header][seg 0 body][boundary 1][seg 1 body]...[trailer]

Each live segment chooses stored or coded by estimated bit cost; coded
segments share one Huffman table (dynamic / fixed / literal-only, chosen
per shard by exact cost); stored runs merge into stored blocks of up to
65535 bytes.  Every shard ends with an empty stored block: the sync
marker, or the BFINAL block of the last shard.

u32 values are carried as int64, and the field values leave as int32 u32
bit patterns, the packer's width.  The stored/coded estimate is the JAX
formula, computed so that it is the same on every device and in every
order of the symbols: log2 is taken in float64 and rounded once to
float32 (squeeze's rule), and a segment's sum of counts times those
float32 lengths is exact in float64 and rounded once to float32 before
the comparison.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import consts, tables
from . import encode as enc
from . import header as hdr
from . import huff
from . import onehot
from . import squeeze as sq

MAX_STORED = consts.MAX_STORED_BLOCK            # 65535

# Fixed code tables.  Lengths may be truncated to the emittable symbol
# range, but CODES must come from the FULL 288/32 canonical assignment:
# dropping symbols 286-287 before assignment shifts every 9-bit code by 4
# (bytes >= 144 would emit wrong-but-valid streams).
_FIX_LL_LENS = np.asarray(tables.FIXED_LITLEN_LENS[:consts.NUM_LITLEN],
                          dtype=np.int64)
_FIX_D_LENS = np.asarray(tables.FIXED_DIST_LENS[:consts.NUM_DIST],
                         dtype=np.int64)
_FIX_LL_PACKED = (tables.FIXED_LITLEN_CODES[:consts.NUM_LITLEN]
                  .astype(np.int64) | (_FIX_LL_LENS << 24))
_FIX_D_PACKED = (tables.FIXED_DIST_CODES[:consts.NUM_DIST]
                 .astype(np.int64) | (_FIX_D_LENS << 24))

KIND_DYN, KIND_FIX, KIND_LIT, KIND_STO = 0, 1, 2, 3

# stored-over-coded hysteresis (bits): a segment goes stored only when it
# saves at least this much
_HYST = 192


def seg_size(S: int, blk: int = 1024) -> int:
    """Segment size: parse-block aligned, <= MAX_STORED, ~32 per shard."""
    if blk > MAX_STORED:
        raise ValueError("parse block exceeds a stored block")
    nblk = -(-S // blk)
    target = blk * max(1, -(-nblk // 32))
    cap = (MAX_STORED // blk) * blk
    return min(target, cap)


def _nseg(S: int, seg: int) -> int:
    return -(-S // seg)


def slot_count(S: int, seg: int | None = None) -> int:
    """Total field slots for a shard of S positions (padded to 512)."""
    seg = seg or seg_size(S)
    raw = _nseg(S, seg) * (4 + hdr.HDR_SLOTS) + 2 * S + 4
    return -(-raw // 512) * 512


# Approximate code lengths from a histogram (B, n), for the stored/coded
# decision only (emission uses exact package-merge tables): the JAX
# _entropy_bits is the formula of the squeeze's estimate, and the port
# computes both by squeeze's device-independent rule.
_entropy_bits = sq._entropy_lens


def _coded_est(hll_seg: torch.Tensor, hdd_seg: torch.Tensor,
               extras_seg: torch.Tensor) -> torch.Tensor:
    """(B, nseg, 286) and (B, nseg, 30) segment histograms, (B, nseg)
    extra bits -> (B, nseg) float32 estimated coded bits of each segment:
    its counts times the shard's _entropy_bits, plus its extra bits.  A
    product of a count (at most 65,535) and a float32 length in [1, 15]
    is exact in float64, and so is their sum over a segment (below 2^21,
    on a grid of 2^-23), so the sum has one value in any order of the
    symbols and on any device; it is rounded to float32 once."""
    f64 = torch.float64
    ll_ebits = _entropy_bits(hll_seg.sum(dim=1)).to(f64)      # (B, 286)
    d_ebits = _entropy_bits(hdd_seg.sum(dim=1)).to(f64)
    est = ((hll_seg.to(f64) * ll_ebits[:, None, :]).sum(dim=2)
           + (hdd_seg.to(f64) * d_ebits[:, None, :]).sum(dim=2)
           + extras_seg.to(f64))
    return est.to(torch.float32)


@functools.lru_cache(maxsize=None)
def _consts(S: int, seg: int, device: torch.device) -> dict:
    """The host-made constants of build_fields on `device`, made once per
    (shard, segment, device) so that no call copies from host memory (a
    CUDA graph captures none): segment lengths and starts, the
    merge-grid columns, and the fixed tables' lengths and packed
    codes."""
    nseg = _nseg(S, seg)
    merge = max(1, MAX_STORED // seg)
    host = {"seg_len": np.minimum(seg, S - seg * np.arange(nseg)),
            "seg_start": seg * np.arange(nseg),
            "grid": (np.arange(nseg) % merge == 0)[None, :],
            "fix_ll": _FIX_LL_LENS[None, :], "fix_d": _FIX_D_LENS[None, :],
            "fix_ll_packed": _FIX_LL_PACKED[None, :],
            "fix_d_packed": _FIX_D_PACKED[None, :]}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def build_fields(window_tail: torch.Tensor, mlen: torch.Tensor,
                 mdist: torch.Tensor, starts: torch.Tensor,
                 take: torch.Tensor, valid_len: torch.Tensor,
                 final: torch.Tensor, S: int, seg: int | None = None):
    """All-device stream planning for a batch of shards.

    window_tail (B, S) uint8 shard bytes; mlen/mdist/starts/take (B, S)
    parse results; valid_len (B,) real bytes per shard; final (B,)
    last-shard flag.  Returns (vals (B, SLOTS) int32 u32 bit patterns,
    bits (B, SLOTS) int32, total_bits (B,) int64, kind (B,) int64)."""
    if seg is None:
        seg = seg_size(S)
    nseg = _nseg(S, seg)
    P = nseg * seg
    MERGE = max(1, MAX_STORED // seg)
    B = window_tail.shape[0]
    dev = window_tail.device
    i64 = torch.int64

    geo = _consts(S, seg, dev)
    wt = window_tail.to(i64)
    mlen = mlen.to(i64)
    mdist = mdist.to(i64)
    valid_len = valid_len.to(i64)
    pos = torch.arange(S, dtype=i64, device=dev)[None, :]
    live_pos = pos < valid_len[:, None]
    tok_start = starts & live_pos
    is_m = take & tok_start
    final = final.to(i64)

    def segview(x):
        """(B, S) -> (B*nseg, seg), zero-padded."""
        if P > S:
            x = torch.nn.functional.pad(x, (0, P - S))
        return x.reshape(B * nseg, seg)

    def segsum(x):
        return segview(x.to(i64)).sum(dim=1).reshape(B, nseg)

    # ---- token symbols / extras (position order) ----
    lcode = enc.length_code(torch.clamp(mlen, min=3))
    lev, leb = enc.length_extra(torch.clamp(mlen, min=3), lcode)
    dcode = enc.dist_code(torch.clamp(mdist, min=1))
    dev_, deb = enc.dist_extra(torch.clamp(mdist, min=1), dcode)
    llsym = torch.where(is_m, 257 + lcode, wt)
    llsym = torch.where(tok_start, llsym, 0)
    dsym = torch.where(is_m, dcode, 0)

    # ---- per-segment histograms ----
    hll_seg = onehot.hist_onehot(segview(llsym), segview(tok_start),
                                 consts.NUM_LITLEN).reshape(B, nseg, -1)
    hdd_seg = onehot.hist_onehot(segview(dsym), segview(is_m),
                                 consts.NUM_DIST).reshape(B, nseg, -1)
    hbyte_seg = onehot.hist_onehot(
        segview(torch.where(live_pos, wt, 0)), segview(live_pos),
        consts.NUM_LITLEN).reshape(B, nseg, -1)
    extras_seg = segsum(torch.where(is_m, leb + deb, 0))

    # ---- segment geometry ----
    seg_len, seg_start = geo["seg_len"], geo["seg_start"]
    live_bytes = torch.minimum(
        torch.clamp(valid_len[:, None] - seg_start[None, :], min=0),
        seg_len[None, :])
    live_seg = live_bytes > 0

    # ---- pass 1: entropy-estimated coded cost -> stored decision ----
    coded_est = _coded_est(hll_seg, hdd_seg, extras_seg)
    stored_est = (8 * live_bytes + 40).to(torch.float32)
    want_stored = coded_est > stored_est + _HYST

    # tokens crossing a segment boundary force both sides into one
    # representation (foreign, non-block-aligned parses only)
    next_bnd = (pos // seg + 1) * seg
    crosses = segsum(is_m & (pos + mlen > next_bnd)) > 0      # (B, nseg)
    seg_stored = want_stored & live_seg
    cols = [seg_stored[:, 0]]
    for j in range(1, nseg):
        cols.append(torch.where(crosses[:, j - 1] & live_seg[:, j],
                                cols[j - 1], seg_stored[:, j]))
    seg_stored = torch.stack(cols, dim=1) & live_seg
    seg_coded = live_seg & ~seg_stored

    def prev_col(x):
        return torch.nn.functional.pad(x[:, :-1], (1, 0), value=False)

    open_j = seg_coded & ~prev_col(seg_coded)
    nopen = open_j.sum(dim=1)

    # ---- pass 2: exact tables over coded segments only ----
    cmask = seg_coded[:, :, None]
    hll = torch.where(cmask, hll_seg, 0).sum(dim=1)
    hdd = torch.where(cmask, hdd_seg, 0).sum(dim=1)
    hbyte = torch.where(cmask, hbyte_seg, 0).sum(dim=1)
    eobs = torch.clamp(nopen, min=1)
    hll[:, consts.END_OF_BLOCK] += eobs
    hbyte[:, consts.END_OF_BLOCK] += eobs
    extras = torch.where(seg_coded, extras_seg, 0).sum(dim=1)

    d1 = torch.zeros(consts.NUM_DIST, dtype=i64, device=dev)
    d1[0].fill_(1)            # a fill, not a host copy: capture-safe
    ll_lens = huff.pm_lengths(hll, consts.MAX_CODE_BITS)
    d_lens = huff.pm_lengths(hdd, consts.MAX_CODE_BITS)
    no_d = d_lens.sum(dim=1) == 0
    d_lens = torch.where(no_d[:, None], d1[None, :], d_lens)
    lit_lens = huff.pm_lengths(hbyte, consts.MAX_CODE_BITS)
    lit_d = d1[None, :].expand(B, consts.NUM_DIST)

    zeros_b = torch.zeros(B, dtype=i64, device=dev)   # BFINAL always 0
    dyn_hv, dyn_hb, dyn_hbits = hdr.build_headers(ll_lens, d_lens, zeros_b)
    lit_hv, lit_hb, lit_hbits = hdr.build_headers(lit_lens, lit_d, zeros_b)

    # ---- shard-level coded-table-family selection (exact bit costs) ----
    stored_bytes = torch.where(seg_stored, live_bytes, 0).sum(dim=1)
    stored_hdrs = torch.where(seg_stored.any(dim=1),
                              -torch.div(-stored_bytes, MERGE * seg,
                                         rounding_mode="floor") + 1, 0)
    stored_const = 44 * stored_hdrs + 8 * stored_bytes
    dyn_cost = nopen * dyn_hbits + huff.coded_size(hll, ll_lens) \
        + huff.coded_size(hdd, d_lens) + extras + stored_const
    fix_ll, fix_d = geo["fix_ll"], geo["fix_d"]
    fix_cost = nopen * 3 + huff.coded_size(hll, fix_ll) \
        + huff.coded_size(hdd, fix_d) + extras + stored_const
    lit_cost = nopen * lit_hbits + huff.coded_size(hbyte, lit_lens) \
        + stored_const
    all_sto_hdrs = torch.clamp(
        -torch.div(-valid_len, MERGE * seg, rounding_mode="floor"), min=1)
    sto_cost = 44 * all_sto_hdrs + 8 * valid_len

    costs = torch.stack([dyn_cost, fix_cost, lit_cost, sto_cost], dim=1)
    kind = torch.argmin(costs, dim=1)
    k_dyn = (kind == KIND_DYN)[:, None]
    k_fix = (kind == KIND_FIX)[:, None]
    k_lit = (kind == KIND_LIT)[:, None]

    # all-stored shards: every live segment goes raw
    seg_stored = torch.where((kind == KIND_STO)[:, None], live_seg,
                             seg_stored)
    seg_coded = live_seg & ~seg_stored
    prev_coded = prev_col(seg_coded)
    open_j = seg_coded & ~prev_coded
    close_j = prev_coded & seg_stored
    hdr_here = seg_stored & (~prev_col(seg_stored) | geo["grid"])

    # merged stored-run byte cover per header (backward accumulation)
    covers = [None] * nseg
    nxt = torch.zeros(B, dtype=i64, device=dev)
    for j in range(nseg - 1, -1, -1):
        c = live_bytes[:, j]
        if j + 1 < nseg:
            cont = seg_stored[:, j + 1] & ~hdr_here[:, j + 1]
            c = c + torch.where(cont, nxt, 0)
        covers[j] = c
        nxt = c
    cover = torch.stack(covers, dim=1)

    # ---- selected code tables ----
    ll_sel_lens = torch.where(k_dyn, ll_lens,
                              torch.where(k_fix, fix_ll, lit_lens))
    d_sel_lens = torch.where(k_dyn, d_lens, torch.where(k_fix, fix_d, lit_d))
    ll_tab = huff.packed_tables(ll_sel_lens, consts.MAX_CODE_BITS)
    d_tab = huff.packed_tables(d_sel_lens, consts.MAX_CODE_BITS)
    # fixed blocks use the full-table codes (see _FIX_LL_PACKED)
    ll_tab = torch.where(k_fix, geo["fix_ll_packed"], ll_tab)
    d_tab = torch.where(k_fix, geo["fix_d_packed"], d_tab)

    # ---- selected block-header fields (replicated per opening) ----
    hv = torch.where(k_dyn, dyn_hv, lit_hv)
    hb = torch.where(k_dyn, dyn_hb, lit_hb)
    fix_hv = torch.zeros_like(dyn_hv)
    fix_hv[:, 0].fill_(1 << 1)
    fix_hb = torch.zeros_like(dyn_hb)
    fix_hb[:, 0].fill_(3)
    hv = torch.where(k_fix, fix_hv, hv)
    hb = torch.where(k_fix, fix_hb, hb)
    hbits_sel = hb.sum(dim=1)

    # ---- body fields (2 per position) ----
    stored_pos = seg_stored[:, :, None].expand(B, nseg, seg).reshape(
        B, P)[:, :S]
    lle = onehot.lookup_onehot(ll_tab, llsym)
    dde = onehot.lookup_onehot(d_tab, dsym)
    llc, llb = lle & 0xFFFFFF, lle >> 24
    ddc, ddb = dde & 0xFFFFFF, dde >> 24
    # field a: litlen code + length extra (code low, extra high)
    fa_tok_v = llc | (torch.where(is_m, lev, 0) << llb)
    fa_tok_b = torch.where(tok_start, llb + torch.where(is_m, leb, 0), 0)
    # field b: dist code + dist extra
    fb_tok_v = torch.where(is_m, ddc | (dev_ << ddb), 0)
    fb_tok_b = torch.where(is_m, ddb + deb, 0)
    # literal-only: every live byte coded with the selected table
    lit_e = onehot.lookup_onehot(ll_tab, wt)
    fa_lit_v = lit_e & 0xFFFFFF
    fa_lit_b = torch.where(live_pos, lit_e >> 24, 0)

    fa_cod_v = torch.where(k_lit, fa_lit_v, fa_tok_v)
    fa_cod_b = torch.where(k_lit, fa_lit_b, fa_tok_b)
    fa_v = torch.where(stored_pos, wt, fa_cod_v)
    fa_b = torch.where(stored_pos, torch.where(live_pos, 8, 0), fa_cod_b)
    fb_v = torch.where(stored_pos | k_lit, 0, fb_tok_v)
    fb_b = torch.where(stored_pos | k_lit, 0, fb_tok_b)

    body_v = torch.stack([fa_v, fb_v], dim=2).reshape(B, 2 * S)
    body_b = torch.stack([fa_b, fb_b], dim=2).reshape(B, 2 * S)
    body_bits_seg = segsum(fa_b + fb_b)

    # ---- boundary regions + running bit account (nseg <= 32) ----
    eob_e = ll_tab[:, consts.END_OF_BLOCK]
    eob_v = eob_e & 0xFFFFFF
    eob_b = eob_e >> 24
    zero_b = torch.zeros(B, dtype=i64, device=dev)

    parts_v, parts_b = [], []
    bits_run = torch.zeros(B, dtype=i64, device=dev)
    for j in range(nseg):
        cl, hh, op = close_j[:, j], hdr_here[:, j], open_j[:, j]
        s0_b = torch.where(cl, eob_b, 0)
        bits_run = bits_run + s0_b
        pad = torch.remainder(-(bits_run + 3), 8)
        s1_b = torch.where(hh, 3 + pad, 0)
        s2_b = torch.where(hh, 16, 0)
        bits_run = bits_run + torch.where(hh, 35 + pad, 0)
        h_b = torch.where(op[:, None], hb, 0)
        bits_run = bits_run + torch.where(op, hbits_sel, 0)
        bits_run = bits_run + body_bits_seg[:, j]
        cov = cover[:, j]
        parts_v.append(torch.stack([eob_v, zero_b, cov, (~cov) & 0xFFFF],
                                   dim=1))
        parts_v.append(hv)
        parts_b.append(torch.stack([s0_b, s1_b, s2_b, s2_b], dim=1))
        parts_b.append(h_b)
        lo, hi = 2 * j * seg, min(2 * (j + 1) * seg, 2 * S)
        parts_v.append(body_v[:, lo:hi])
        parts_b.append(body_b[:, lo:hi])

    # ---- trailer: close the last coded block, then the empty stored
    # block that is the sync marker (BFINAL=0) or final block (BFINAL=1)
    last_live = torch.clamp(
        -torch.div(-valid_len, seg, rounding_mode="floor") - 1, 0, nseg - 1)
    last_coded = (valid_len > 0) & torch.gather(seg_coded, 1,
                                                last_live[:, None])[:, 0]
    t_eob_b = torch.where(last_coded, eob_b, 0)
    bits_run = bits_run + t_eob_b
    m1_b = 3 + torch.remainder(-(bits_run + 3), 8)
    parts_v.append(torch.stack([eob_v, final, zero_b,
                                torch.full_like(zero_b, 0xFFFF)], dim=1))
    parts_b.append(torch.stack([t_eob_b, m1_b, torch.full_like(zero_b, 16),
                                torch.full_like(zero_b, 16)], dim=1))
    total_bits = bits_run + m1_b + 32

    vals = torch.cat(parts_v, dim=1)
    bits = torch.cat(parts_b, dim=1)
    pad_slots = slot_count(S, seg) - vals.shape[1]
    if pad_slots < 0:
        raise AssertionError("field slots overflow")
    vals = torch.nn.functional.pad(vals, (0, pad_slots))
    bits = torch.nn.functional.pad(bits, (0, pad_slots)).to(torch.int32)
    # dead fields must carry zero values: the packer ORs values verbatim;
    # the packer reads them as int32 u32 bit patterns (every value < 2^28)
    vals = torch.where(bits > 0, vals.to(torch.int32), 0)
    return vals, bits, total_bits, kind
