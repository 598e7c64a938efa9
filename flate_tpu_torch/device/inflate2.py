"""Device inflate — speculative parallel decode of FLT1-indexed members.

Counterpart of flate_tpu/jx/inflate2.py.  Three passes:

1. **Speculative symbol decode at every bit offset** (`_pass1`): plain
   tensor arithmetic.  Each position's 15-bit LSB-first window is
   bit-reversed and decoded with the canonical (Moffat-Turpin) threshold
   method against 15 per-shard left-justified limits; chained fields
   (length extra, distance code, distance extra) read a staggered 48-bit
   window with data-dependent shifts.  Result: one packed word per bit
   position, adv(6) | kind(2)<<6 | value(8)<<8 | (dist-1)(15)<<16.

2. **True-path walk**: the orbit of the body start through `adv` visits
   exactly the true symbols.  `_lane_walk` (CUDA kernel B6) cuts the bits
   into lanes that walk concurrently and joins the true chain onto each
   lane's chain; `_extract` compacts the proven chain.  `_walk` (CUDA
   kernel B7) is the exact serial walk, one symbol per step.

3. **Parallel LZ resolution** (`_resolve`): per-symbol output spans by
   cumsum; every output byte gets a source pointer (literals point at
   themselves, match bytes strictly left); rounds of pointer doubling land
   every byte on its originating literal.

Shard boundaries come from the FLT1 index (an RFC 1952 EXTRA subfield the
encoder writes), so a member decodes shard-parallel.  A member without an
index raises LookupError here; api.decompress then decodes that member through
device/anyinflate.py.

On CUDA tensors the two walks launch their kernels
(csrc/decode_kernels.cu); on CPU tensors they run the plain PyTorch
versions beside them.  Words are int32 (they fit 31 bits); the one u32
quantity that does not fit, the second pack of propagate_match_fields, is
carried as int64.
"""

from __future__ import annotations

import collections
import functools
import os

import numpy as np
import torch

from .. import _build, consts, metrics, tables
from .. import inflate as hinf
from ..containers import Container, Hasher, parse_footer, parse_header
from ..errors import (EndOfStream, FlateError, InvalidBlockType,
                      WrongStoredBlockNlen)
from ..shard_index import parse_index_extra
from . import onehot, resolve_device, to_i32

CTX = consts.MAX_DISTANCE

K_LIT, K_MATCH, K_EOB, K_BAD = 0, 1, 2, 3

LANE_G = 2048                    # lane width in bits
LANE_J = 96                      # max join-walk steps

# What the decode entry points did, by name: "decode_batch2" and
# "decode_batch" count device batches of the indexed route (lane walk and
# serial walk), "serial_retries" the lane-walk batches walked again
# serially after an unproven speculation, "segmented_reroutes" the members
# sent on to the chained route, "chained_members" the members
# device/anyinflate.py decoded, "chain_heads" their chain heads (bit 0,
# the scanner's chunk entries or a re-routed member's shard offsets),
# "chained_rounds" the device rounds of their chained decode,
# "continuation_rows" the rows they planned after a row that reached
# MAX_SPAN bytes without its block's end-of-block (a block of any
# compressed length decodes as such rows), and "false_heads" the chain
# heads before where the decoded chain stopped that are not block starts on
# it (a scanner entry that only looked like a header; an FLT1 index's
# entries are all block starts).
STATS: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# Host-side per-shard planning: block header -> canonical scalars
# ---------------------------------------------------------------------------

def canonical_scalars(lens: np.ndarray, nsyms: int):
    """(lj_lims[16] u32, kbase[16] i32, syms[nsyms] i32) for the
    threshold decoder.  lens: per-symbol code lengths (0 = unused)."""
    lens = np.asarray(lens, np.int32)
    count = np.bincount(lens, minlength=16)[:16]
    count[0] = 0
    lims = np.zeros(16, np.uint32)
    kbase = np.zeros(16, np.int32)
    first = 0
    offset = 0
    for l in range(1, 16):
        first <<= 1
        kbase[l] = offset - first
        offset += int(count[l])
        first += int(count[l])
        lims[l] = min(first << (15 - l), 1 << 15)
    order = np.argsort(lens + (np.arange(len(lens)) + 1) * 16384 *
                       (lens == 0), kind="stable")
    live = int((lens > 0).sum())
    syms = np.zeros(nsyms, np.int32)
    syms[:live] = order[:live]
    return lims, kbase, syms


class ShardPlan:
    """One shard's decode plan: `stored` spans, `coded` scalars, or
    `mixed` (stored then coded blocks: a segmented shard)."""

    __slots__ = ("kind", "stored_spans", "start_bit", "final",
                 "ll", "d", "out_len", "end_bit", "end_final")

    def __init__(self):
        self.kind = "coded"
        self.stored_spans = None


def plan_shard(comp: bytes, out_len: int) -> ShardPlan:
    """Parse the shard's block header(s) on host (tiny, serial-cheap).

    Shards are a run of stored blocks (`stored`), start with a coded
    block (`coded` — if more blocks follow, the device decode comes up
    short and the caller re-routes the member), or mix stored-then-coded
    blocks (`mixed`)."""
    p = ShardPlan()
    p.out_len = out_len
    bits = hinf._BitCursor(comp)
    bfinal = bits.read(1)
    btype = bits.read(2)
    p.final = bfinal
    if btype == 0:
        spans = []
        bits.align_to_byte()
        while True:
            ln = bits.read(16)
            nlen = bits.read(16)
            if (ln ^ nlen) & 0xFFFF != 0xFFFF:
                raise WrongStoredBlockNlen("stored LEN/NLEN mismatch")
            spans.append((bits.pos >> 3, ln))
            bits.pos += ln * 8
            if bfinal or sum(s[1] for s in spans) >= out_len:
                break
            bfinal = bits.read(1)
            if bits.read(2) != 0:
                p.kind = "mixed"
                return p
            bits.align_to_byte()
        p.kind = "stored"
        p.stored_spans = spans
        # where the stored data ends, and whether its last block is final
        p.end_bit, p.end_final = bits.pos, bfinal
        return p
    if btype == 1:
        ll_lens = np.asarray(tables.FIXED_LITLEN_LENS, np.int32)
        d_lens = np.asarray(tables.FIXED_DIST_LENS, np.int32)
    elif btype == 2:
        ll_lens, d_lens = hinf.decode_dynamic_header_lens(bits)
        hinf.check_completeness(ll_lens, consts.MAX_CODE_BITS, True)
        hinf.check_completeness(d_lens, consts.MAX_CODE_BITS, False)
    else:
        raise InvalidBlockType(f"block type {btype}")
    p.start_bit = bits.pos
    p.ll = canonical_scalars(ll_lens, 288)
    p.d = canonical_scalars(d_lens, 32)
    return p


# ---------------------------------------------------------------------------
# Pass 1 — speculative decode at every bit offset (tensor arithmetic)
#
# All of it runs in int32.  A bit window holds a u32 as its int32 bit
# pattern; every field is read as (window >> rel) & mask with rel <= 15 and
# a mask of at most 15 bits, so the sign bits an arithmetic shift brings in
# (the top `rel` bits) are never kept.
# ---------------------------------------------------------------------------

def _rev15(v: torch.Tensor) -> torch.Tensor:
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
    return v >> 1


def _bit_windows32(comp: torch.Tensor) -> torch.Tensor:
    """comp (B, C) u8 -> u (B, 8C + 40) int32 bit patterns:
    u[p] = LSB-first bits [p, p+32).  Eight shifted variants of the
    byte-aligned windows, one per bit-in-byte, no gathers."""
    B, C = comp.shape
    ext = torch.nn.functional.pad(comp, (0, 13)).to(torch.int64)
    dw = (ext[:, :C + 5] | (ext[:, 1:C + 6] << 8)
          | (ext[:, 2:C + 7] << 16) | (ext[:, 3:C + 8] << 24))
    b4 = ext[:, 4:C + 9]
    lanes = [to_i32(dw)]
    for s in range(1, 8):
        lanes.append(to_i32(((dw >> s) | (b4 << (32 - s))) & 0xFFFFFFFF))
    return torch.stack(lanes, dim=2).reshape(B, -1)


def _field(u0, u1, u2, off, width_mask: int):
    """Extract `width <= 15` bits at data-dependent offset off in [0, 48)
    from the staggered windows (u_k = bits [16k, 16k+32))."""
    rel = off & 15
    k = off >> 4
    v = torch.where(k == 0, u0 >> rel, torch.where(k == 1, u1 >> rel,
                                                   u2 >> rel))
    return v & width_mask


def _thresh_decode(v15, lims, kbase):
    """Canonical threshold decode: v15 (B, N) left-justified 15-bit
    values; lims/kbase (B, 16).  Returns (L, idx) (B, N) int32; L == 16
    marks invalid codes."""
    lims = lims.to(torch.int32)
    L = torch.ones_like(v15)
    for l in range(1, 16):
        L += v15 >= lims[:, l:l + 1]
    # kbase[L], 0 for the invalid L == 16
    kb = torch.gather(torch.nn.functional.pad(kbase.to(torch.int32), (0, 1)),
                      1, L.to(torch.int64))
    idx = (v15 >> torch.clamp(15 - L, 0, 15)) + kb
    return L, idx


def _length_decode(li):
    """Arithmetic LENGTH_BASE / extra bits from length-code index li
    (0..28) — closed forms of tables.LENGTH_BASE/LENGTH_EXTRA_BITS."""
    e = torch.clamp((li >> 2) - 1, min=0)
    base = ((4 + (li & 3)) << e) + 3
    base = torch.where(li < 4, li + 3, base)
    base = torch.where(li == 28, 258, base)
    eb = torch.where((li < 4) | (li == 28), 0, e)
    return base, eb


def _dist_decode(di):
    """Arithmetic DIST_BASE / extra bits from distance-code index."""
    e = torch.clamp((di >> 1) - 1, min=0)
    base = ((2 + (di & 1)) << e) + 1
    base = torch.where(di < 2, di + 1, base)
    eb = torch.where(di < 2, 0, e)
    return base, eb


def _pass1(comp, lims_ll, kbase_ll, syms_ll, lims_d, kbase_d, syms_d):
    """Packed speculative word per bit position, (B, 8C) int32:
    adv(6 bits, 0..48) | kind(2) << 6 | value(8) << 8 | (dist-1)(15) << 16.
    """
    B, C = comp.shape
    u = _bit_windows32(comp)
    N = 8 * C
    u0 = u[:, :N]
    u1 = u[:, 16:16 + N]
    u2 = u[:, 32:32 + N]

    v15 = _rev15(u0 & 0x7FFF)
    L, idx = _thresh_decode(v15, lims_ll, kbase_ll)
    bad = L > 15
    idx = torch.clamp(idx, 0, syms_ll.shape[1] - 1)
    sym = onehot.lookup_onehot(syms_ll.to(torch.int32), idx)

    is_eob = (sym == 256) & ~bad
    is_m = (sym > 256) & ~bad
    li = torch.clamp(sym - 257, 0, 28)
    bad |= sym - 257 > 28
    lbase, leb = _length_decode(li)
    lev = _field(u0, u1, u2, L, 0x1FFF) & ((1 << leb) - 1)
    length = lbase + lev

    o2 = L + leb
    vd15 = _rev15(_field(u0, u1, u2, o2, 0x7FFF))
    Ld, idxd = _thresh_decode(vd15, lims_d, kbase_d)
    bad |= is_m & (Ld > 15)
    idxd = torch.clamp(idxd, 0, syms_d.shape[1] - 1)
    dsym = onehot.lookup_onehot(syms_d.to(torch.int32), idxd)
    bad |= is_m & (dsym > 29)
    di = torch.clamp(dsym, 0, 29)
    dbase, deb = _dist_decode(di)
    o3 = o2 + Ld
    dev = _field(u0, u1, u2, o3, 0x1FFF) & ((1 << deb) - 1)
    dist = dbase + dev

    adv = torch.where(is_m, o3 + deb, L)
    kind = is_m.to(torch.int32)                     # K_MATCH or K_LIT
    kind = torch.where(is_eob, K_EOB, kind)
    kind = torch.where(bad, K_BAD, kind)
    value = torch.where(is_m, length - 3, sym & 0xFF)
    adv = torch.where(bad, 1, adv)
    return (adv | (kind << 6) | (value << 8)
            | (torch.where(is_m, dist - 1, 0) << 16)).to(torch.int32)


# ---------------------------------------------------------------------------
# Pass 2 — exact serial walk (kernel B7): visit true symbol starts, emit
# compacted words
# ---------------------------------------------------------------------------

def _walk_plain(word: torch.Tensor, start: torch.Tensor,
                nbits: torch.Tensor, NS: int):
    """The chain's positions by doubling, not one step at a time:
    P[i] = next^i(start), where next(p) is p + adv, or the end of the bits
    n after an end-of-block word, and n is a sink.  P[2^k:2^(k+1)] is
    next^(2^k) of P[:2^k], and the table of next^(2^k) doubles beside it,
    so a row of N positions takes log2(NS) rounds of gathers.  The chain
    never moves back, so its positions before n are a prefix of P."""
    B, N = word.shape
    dev = word.device
    n = torch.clamp(nbits.to(torch.int64), max=N)[:, None]
    pos = torch.arange(N + 1, dtype=torch.int64, device=dev)[None, :]
    w = torch.nn.functional.pad(word, (0, 1)).to(torch.int64)
    nxt = torch.where(((w >> 6) & 3) == K_EOB, n, pos + (w & 63))
    nxt = torch.where(pos >= n, n, torch.minimum(nxt, n))
    s = start.to(torch.int64)[:, None]
    P = torch.where((s >= 0) & (s < n), s, n)
    while P.shape[1] < NS:
        P = torch.cat([P, torch.gather(nxt, 1, P)], dim=1)
        if P.shape[1] < NS:
            nxt = torch.gather(nxt, 1, nxt)
    P = P[:, :NS]
    live = P < n
    out = torch.where(live, torch.gather(word, 1, torch.clamp(P, max=N - 1)),
                      0)
    return out.to(torch.int32).contiguous(), live.sum(dim=1).to(torch.int32)


def _walk(word: torch.Tensor, start: torch.Tensor, nbits: torch.Tensor,
          NS: int):
    """word (B, N) int32 -> (symbol words (B, NS) int32, counts (B,)
    int32): the words of the chain from `start`, in order, through the
    first end-of-block word, the end of the bits or NS words."""
    if _build.use_plain(word):
        return _walk_plain(word, start, nbits, NS)
    B, N = word.shape
    start = start.to(torch.int32).contiguous()
    nbits = nbits.to(torch.int32).contiguous()
    _build.check_cuda("walk.word", word, torch.int32, (B, N))
    _build.check_cuda("walk.start", start, torch.int32, (B,))
    _build.check_cuda("walk.nbits", nbits, torch.int32, (B,))
    out = torch.empty((B, NS), dtype=torch.int32, device=word.device)
    count = torch.empty(B, dtype=torch.int32, device=word.device)
    _build.launch("flate_walk", word.data_ptr(), start.data_ptr(),
                  nbits.data_ptr(), out.data_ptr(), count.data_ptr(),
                  B, N, NS)
    return out, count


# ---------------------------------------------------------------------------
# Pass 2 (lanes) — speculative multi-lane walk with join resolve (kernel B6)
#
# The bitstream is cut into NL lanes of G bits; every lane walks the
# adv-chain from its base concurrently, so steps ~ symbols per lane, not
# per shard.  A lane that starts mid-symbol self-synchronizes: its chain
# and the true chain are both strictly increasing, so they collide within
# a few symbols.  Exactness is restored by the JOIN phase: the true chain
# enters lane l at the previous lane's exit and is walked at most J steps
# until it lands on a lane-visited position; from there the lane's own
# chain IS the true chain.  Lanes whose join fails (possible but rare)
# flag the shard for an exact retry — never wrong bytes.
# ---------------------------------------------------------------------------

def _lane_walk_plain(word: torch.Tensor, start: torch.Tensor,
                     nbits: torch.Tensor, G: int, J: int,
                     steps: dict | None = None):
    """All (row, lane) pairs step together; a Python loop over steps.
    `steps`, if given, receives the counts of chain steps the data needed
    ("phase1_steps", "join_steps")."""
    B, N = word.shape
    NL = N // G
    dev = word.device
    w = word.reshape(B, NL, G)
    lane = torch.arange(NL, dtype=torch.int64, device=dev)[None, :]
    lbase = lane * G
    s0 = start.to(torch.int64)[:, None]
    n = nbits.to(torch.int64)[:, None]
    l0 = torch.div(s0, G, rounding_mode="floor")
    vac = (lane < l0) | (lbase >= n)                    # vacuous lanes
    ent0 = s0 - lbase                    # exact entry of the start lane

    def adv_at(idx):
        return torch.clamp(torch.gather(w, 2, idx)[..., 0].to(torch.int64)
                           & 63, min=1)

    # ---- phase 1: speculative walk from every lane base ----
    c = torch.where(lane == l0, ent0, 0)
    c = torch.where(vac, G, c)
    vis = torch.zeros((B, NL, G), dtype=torch.bool, device=dev)
    n1 = torch.zeros((), dtype=torch.int64, device=dev)
    n2 = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        act = c < G
        if not bool(act.any()):
            break
        n1 += act.sum()
        idx = torch.clamp(c, 0, G - 1)[..., None]
        vis.scatter_(2, idx, torch.gather(vis, 2, idx) | act[..., None])
        c = torch.where(act, c + adv_at(idx), c)

    # ---- phase 2: join the true chain onto each lane's chain ----
    ent = torch.roll(c, 1, dims=1) - G
    c2 = torch.where(lane == l0, ent0, ent)
    joined = vac.clone()
    jpos = torch.full((B, NL), G, dtype=torch.int64, device=dev)
    jmask = torch.zeros_like(vis)
    for _ in range(J):
        inb = c2 < G
        idx = torch.clamp(c2, 0, G - 1)[..., None]
        hit = torch.gather(vis, 2, idx)[..., 0] & ~joined & inb
        jpos = torch.where(hit, c2, jpos)
        joined = joined | hit
        live = ~joined & inb
        if not bool(live.any()):
            break                        # no later step changes anything
        n2 += live.sum()
        jmask.scatter_(2, idx, torch.gather(jmask, 2, idx) | live[..., None])
        c2 = torch.where(live, c2 + adv_at(idx), c2)

    if steps is not None:
        steps["phase1_steps"], steps["join_steps"] = int(n1), int(n2)
    col = torch.arange(G, dtype=torch.int64, device=dev)
    mask = jmask | (vis & (col >= jpos[..., None])
                    & (joined & ~vac)[..., None])
    return mask.reshape(B, N), joined


# shared memory one block of the lane-walk kernel may take (H100: 227 KiB)
LANE_SMEM = 232448
LANE_MAX_L = 31                  # lanes a block: its walkers fit in one warp


def _lane_shared_bytes(L: int, G: int) -> int:
    """Shared memory of a staged lane-walk block of L lanes (and a halo
    lane) of G positions: per-slot state, two bitmaps, one adv byte a
    position (csrc/decode_kernels.cu, flate_lane_walk)."""
    return (3 * (L + 1) * 4 + 15) // 16 * 16 + (L + 1) * (G // 4 + G)


def _lanes_per_block(B: int, NL: int, G: int, sms: int) -> tuple[int, bool]:
    """(L, staged): the most lanes a block, up to 8, that still give two
    blocks to every SM, cut to what fits in shared memory; staged is False
    when not even one lane and its halo fit (the kernel then walks device
    memory)."""
    L = 8
    while L > 1 and B * -(-NL // L) < 2 * sms:
        L //= 2
    while L > 1 and _lane_shared_bytes(L, G) > LANE_SMEM:
        L //= 2
    return L, _lane_shared_bytes(L, G) <= LANE_SMEM


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lane_walk_cuda(word: torch.Tensor, start: torch.Tensor,
                    nbits: torch.Tensor, G: int, J: int, L: int | None = None,
                    staged: bool | None = None, phases: int = 3):
    """Launch kernel B6 on CUDA tensors: L lanes a block (default
    _lanes_per_block), staged in shared memory or walked in device memory;
    phases < 3 stops the kernel early (timing only: the outputs are then
    incomplete)."""
    B, N = word.shape
    NL = N // G
    start = start.to(torch.int32).contiguous()
    nbits = nbits.to(torch.int32).contiguous()
    _build.check_cuda("lane_walk.word", word, torch.int32, (B, N))
    _build.check_cuda("lane_walk.start", start, torch.int32, (B,))
    _build.check_cuda("lane_walk.nbits", nbits, torch.int32, (B,))
    L0, fits = _lanes_per_block(B, NL, G, _sm_count(word.device.index))
    L = L0 if L is None else L
    staged = fits if staged is None else staged
    if not 1 <= L <= LANE_MAX_L:
        raise ValueError(f"lane walk: {L} lanes a block, not 1..{LANE_MAX_L}")
    # the kernel writes 0 / 1 bytes: bool tensors take them as they are
    mask = torch.empty((B, N), dtype=torch.bool, device=word.device)
    joined = torch.empty((B, NL), dtype=torch.bool, device=word.device)
    scratch = None
    if not staged:                   # each block's two bitmaps, L + 1 slots
        scratch = torch.empty(B * -(-NL // L) * 2 * (L + 1) * (G // 32),
                              dtype=torch.int32, device=word.device)
    _build.launch("flate_lane_walk", word.data_ptr(), start.data_ptr(),
                  nbits.data_ptr(), mask.data_ptr(), joined.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  B, N, G, J, L, phases)
    return mask, joined


def _lane_walk(word: torch.Tensor, start: torch.Tensor, nbits: torch.Tensor,
               *, G: int = LANE_G, J: int = LANE_J):
    """word (B, N) int32 -> (mask (B, N) bool, joined (B, NL) bool):
    membership in the true chain from `start`, and per lane whether its
    part of the chain is proven."""
    B, N = word.shape
    if N % G != 0 or G % 128 != 0:
        raise ValueError(f"lane walk: N={N} must be a multiple of G={G}, "
                         f"and G of 128")
    if _build.use_plain(word):
        return _lane_walk_plain(word, start, nbits, G, J)
    return _lane_walk_cuda(word, start, nbits, G, J)


def _extract(word: torch.Tensor, mask: torch.Tensor, joined: torch.Tensor,
             start: torch.Tensor, NS: int, G: int = LANE_G):
    """Compact the true-chain words into slot order and locate the EOB.

    Returns (words (B, NS) int32, counts (B,) incl. EOB, spec_fail (B,),
    has_eob (B,), out_len (B,), end_bit (B,)).  spec_fail marks shards
    whose lane chain is unproven up to the EOB (join failure) —
    retryable exactly, NOT a stream error.  out_len/end_bit let callers
    decode spans whose output size and bit extent are unknown upfront.

    The compaction is a rank (cumsum of the mask) and a scatter that sends
    every unmasked position and every rank >= NS to a sink column; slots at
    or past `counts` are not part of the result."""
    B, N = word.shape
    dev = word.device
    rank = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    slot = torch.where(mask & (rank < NS), rank, NS).to(torch.int64)
    pos = torch.arange(N, dtype=torch.int32, device=dev)[None, :].expand(B, N)
    words_c = torch.zeros((B, NS + 1), dtype=torch.int32, device=dev
                          ).scatter_(1, slot, word)[:, :NS]
    keys_c = torch.full((B, NS + 1), -1, dtype=torch.int32, device=dev
                        ).scatter_(1, slot, pos)[:, :NS]
    kind = (words_c >> 6) & 3
    is_eob = (kind == K_EOB) & (keys_c >= 0)
    has_eob = is_eob.any(dim=1)
    eob_idx = torch.argmax(is_eob.to(torch.int32), dim=1)
    counts = (eob_idx + 1).to(torch.int32)
    p_eob = torch.gather(keys_c, 1, eob_idx[:, None])[:, 0]
    w_eob = torch.gather(words_c, 1, eob_idx[:, None])[:, 0]
    end_bit = p_eob + (w_eob & 63)
    # output bytes of the true symbols before the EOB
    slots = torch.arange(NS, dtype=torch.int32, device=dev)[None, :]
    live = slots < (counts[:, None] - 1)
    value = (words_c >> 8) & 0xFF
    olen = torch.where(live & (kind == K_MATCH), value + 3,
                       (live & (kind == K_LIT)).to(torch.int32))
    out_len = olen.sum(dim=1).to(torch.int32)
    # every lane from the start lane through the EOB lane must be joined
    NL = N // G
    lanes = torch.arange(NL, dtype=torch.int32, device=dev)[None, :]
    l0 = torch.div(start.to(torch.int32), G, rounding_mode="floor")[:, None]
    le = torch.div(p_eob, G, rounding_mode="floor")[:, None]
    lane_ok = joined | (lanes < l0) | (lanes > le)
    spec_fail = ~lane_ok.all(dim=1) | ~has_eob
    return words_c, counts, spec_fail, has_eob, out_len, end_bit


def _cut(words: torch.Tensor, n: torch.Tensor, start: torch.Tensor,
         nbits: torch.Tensor, joined: torch.Tensor | None = None,
         G: int = LANE_G):
    """Where a row without its end-of-block stops: the leading symbols of
    its chain that lie wholly inside its `nbits` bits, up to the first
    invalid code.  A symbol that runs past the row's last bit was decoded
    from the zeros beyond it; the row after this one decodes it again from
    the real bits.

    words (B, NS): the chain's words in order from `start`, n (B,) of them
    (the serial walk's words, or _extract's compaction of a lane-walk
    mask).  Returns (counts, out_len, end_bit, unproven): the whole
    symbols, their output bytes, the bit where they end (start when there
    is none) and, given the lane walk's `joined`, whether a lane from the
    start's through the end bit's is not joined (None: the serial walk,
    exact).  The word at slot `counts` is the one that stopped the row."""
    B, NS = words.shape
    dev = words.device
    slots = torch.arange(NS, dtype=torch.int32, device=dev)[None, :]
    adv = words & 63
    kind = (words >> 6) & 3
    ends = start.to(torch.int32)[:, None] + torch.cumsum(adv, dim=1,
                                                         dtype=torch.int32)
    whole = ((slots < n[:, None]) & (kind <= K_MATCH)
             & (ends <= nbits.to(torch.int32)[:, None]))
    # the first slot that is not whole; NS when every slot is
    stop = torch.nn.functional.pad(~whole, (0, 1), value=True)
    counts = torch.argmax(stop.to(torch.int32), dim=1).to(torch.int32)
    prefix = slots < counts[:, None]
    end_bit = start.to(torch.int32) + torch.where(prefix, adv, 0).sum(
        dim=1, dtype=torch.int32)
    olen = torch.where(kind == K_MATCH, ((words >> 8) & 0xFF) + 3, 1)
    out_len = torch.where(prefix, olen, 0).sum(dim=1, dtype=torch.int32)
    if joined is None:
        return counts, out_len, end_bit, torch.zeros_like(whole[:, 0])
    lanes = torch.arange(joined.shape[1], dtype=torch.int32,
                         device=dev)[None, :]
    l0 = torch.div(start.to(torch.int32), G, rounding_mode="floor")[:, None]
    le = torch.div(end_bit, G, rounding_mode="floor")[:, None]
    lane_ok = joined | (lanes < l0) | (lanes > le)
    return counts, out_len, end_bit, ~lane_ok.all(dim=1)


def decode_batch2(comp, clen, start, lims_ll, kbase_ll, syms_ll,
                  lims_d, kbase_d, syms_d, out_lens, ctx0, *,
                  S: int, NS: int, G: int = LANE_G, hist_len: int = CTX,
                  end_bit: bool = False):
    """Lane-walk twin of decode_batch; extra return: spec_fail (B,), and
    with end_bit=True the bit (B,) where each row's first end-of-block
    ends."""
    STATS["decode_batch2"] += 1
    with metrics.span("decode.pass1"):
        word = _pass1(comp, lims_ll, kbase_ll, syms_ll, lims_d, kbase_d,
                      syms_d)
    with metrics.span("decode.lane_walk"):
        mask, joined = _lane_walk(word, start, 8 * clen, G=G)
    with metrics.span("decode.extract"):
        words, counts, spec_fail, _, _, end = _extract(word, mask, joined,
                                                       start, NS, G)
    with metrics.span("decode.resolve"):
        out, err = _resolve(words, counts, out_lens, ctx0, S, hist_len)
    if end_bit:
        return out, err, counts, spec_fail, end
    return out, err, counts, spec_fail


# ---------------------------------------------------------------------------
# Pass 3 — parallel LZ resolution over the batch
# ---------------------------------------------------------------------------

def propagate_match_fields(live, is_m, offs, dist, S: int):
    """Per-byte owning-symbol fields (o_ism, o_dist), each (B, S) int32.

    S <= 128K: two packed monotone scatter-max + cummax propagations.  The
    packs are monotone in offs, so cummax tracks the latest symbol at or
    before each byte; offs <= S-1 < 2^17 and dist-1 < 2^15 fit 32 bits
    (carried as int64 here).  Column S is the sink for symbols that are
    not live or lie past the row.

    Larger S (blocks of the chained route, up to 2^22): owner-slot marks
    plus gathers, where the pack no longer fits 32 bits."""
    B, NS = offs.shape
    dev = offs.device
    if S <= 1 << 17:
        idx1 = torch.where(live & (offs < S), offs, S).to(torch.int64)
        val1 = torch.where(live, (offs << 1) | is_m.to(torch.int32), 0)
        v1 = torch.zeros((B, S + 1), dtype=torch.int32, device=dev
                         ).scatter_reduce_(1, idx1, val1.to(torch.int32),
                                           "amax", include_self=True)
        v1 = torch.cummax(v1[:, :S], dim=1).values
        idx2 = torch.where(is_m & (offs < S), offs, S).to(torch.int64)
        val2 = torch.where(is_m, (offs.to(torch.int64) << 15)
                           | (dist - 1).to(torch.int64), 0)
        v2 = torch.zeros((B, S + 1), dtype=torch.int64, device=dev
                         ).scatter_reduce_(1, idx2, val2, "amax",
                                           include_self=True)
        v2 = torch.cummax(v2[:, :S], dim=1).values
        return v1 & 1, (v2 & 0x7FFF).to(torch.int32) + 1
    slots = torch.arange(NS, dtype=torch.int32, device=dev)[None, :]
    idx = torch.where(live & (offs < S), offs, S).to(torch.int64)
    marks = torch.zeros((B, S + 1), dtype=torch.int32, device=dev
                        ).scatter_reduce_(1, idx, torch.where(live, slots, 0),
                                          "amax", include_self=True)
    owner = torch.cummax(marks[:, :S], dim=1).values.to(torch.int64)
    o_ism = torch.gather(is_m.to(torch.int32), 1, owner)
    o_dist = torch.gather(dist, 1, owner)
    return o_ism, o_dist


def symbol_fields(words, counts, out_lens):
    """Per-symbol fields shared by the two resolvers: (live, is_m, is_l,
    value, dist, offs, err) with err (B,) counting bad codes among the
    live symbols, a missing end-of-block at counts-1, and a decoded size
    other than out_lens."""
    B, NS = words.shape
    slots = torch.arange(NS, dtype=torch.int32, device=words.device)[None, :]
    live = slots < (counts[:, None] - 1)     # drop the trailing EOB
    kind = (words >> 6) & 3
    value = (words >> 8) & 0xFF
    dist = ((words >> 16) & 0x7FFF) + 1
    is_m = live & (kind == K_MATCH)
    is_l = live & (kind == K_LIT)
    err = (live & (kind == K_BAD)).sum(dim=1)
    # stream must end with EOB exactly at counts-1
    last = torch.gather(words, 1, torch.clamp(counts - 1, min=0
                                              ).to(torch.int64)[:, None])[:, 0]
    err = err + ((counts < 1) | (((last >> 6) & 3) != K_EOB))
    olen = torch.where(is_m, value + 3, is_l.to(torch.int32))
    ends = torch.cumsum(olen, dim=1, dtype=torch.int32)
    offs = ends - olen
    err = err + (ends[:, -1] != out_lens)
    return live, is_m, is_l, value, dist, offs, err


def run_pointers(o_ism, o_dist, base, out_lens, S: int):
    """Per output byte (B, S): its buffer position `glob`, whether it lies
    inside its row's output, and its source pointer P.

    Constant-distance run composition: consecutive match bytes with the
    same distance d (RLE runs, periodic data) resolve analytically in ONE
    jump to below the run start, instead of log2(depth) pointer-doubling
    rounds: for i in a maximal const-d match run starting at a,
        out[i] == out[a - d + (i - a) % d].
    Every intermediate hop lies inside the run, so the composition is
    exact; singleton runs reproduce the plain source pos - dist."""
    dev = o_ism.device
    pos_in = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    glob = base + pos_in
    in_range = pos_in < out_lens[:, None]
    is_mb = (o_ism > 0) & in_range
    prev_m = torch.nn.functional.pad(is_mb, (1, 0))[:, :S]
    prev_d = torch.nn.functional.pad(o_dist, (1, 0))[:, :S]
    boundary = is_mb & (~prev_m | (prev_d != o_dist))
    a = torch.cummax(torch.where(boundary, pos_in, 0), dim=1).values
    P_run = base + (a - o_dist) + (pos_in - a) % o_dist
    return glob, in_range, torch.where(is_mb, P_run, glob)


def double_pointers(Pf: torch.Tensor) -> torch.Tensor:
    """Pointer doubling to fixpoint — real chains are shallow (match
    ancestry depth), so converge adaptively, at most 40 rounds; one
    fetched flag per round."""
    for _ in range(40):
        p2 = Pf[Pf]
        done = torch.equal(p2, Pf)
        Pf = p2
        if done:
            break
    return Pf


def _resolve(words, counts, out_lens, ctx0, S: int, hist_len: int = CTX):
    """words (B, NS) int32 compacted symbols; ctx0 (CTX,) u8 resolved
    context, whose last `hist_len` bytes are real history: a match that
    reaches before them is an error.  Returns (flat output (B*S,) u8 in
    global layout, err (B,)).

    Shards are consecutive member spans: shard b occupies
    [CTX + b*S, CTX + b*S + out_lens[b]) of the flat buffer (out_lens
    == S except the member tail), so in-batch back-references cross
    shard boundaries exactly like the original stream."""
    B, NS = words.shape
    dev = words.device
    out_lens = out_lens.to(torch.int32)
    live, is_m, is_l, value, dist, offs, err = symbol_fields(
        words, counts, out_lens)

    base = CTX + torch.arange(B, dtype=torch.int32, device=dev)[:, None] * S
    T = CTX + B * S
    # literal placement; slot T is the sink
    lit_pos = torch.where(is_l & (base + offs < T), base + offs, T)
    init = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    init[lit_pos.reshape(-1).to(torch.int64)] = value.reshape(-1)
    init[:CTX] = ctx0.to(torch.int32)

    o_ism, o_dist = propagate_match_fields(live, is_m, offs, dist, S)
    # a reference before the real history: a match's leftmost source byte
    # is base + offs - dist, so one per-symbol test covers every byte
    err = err + (is_m & (base + offs - dist < CTX - hist_len)).sum(dim=1)
    # P_run >= base - CTX >= 0 always (dist <= MAX_DISTANCE == CTX)
    _, _, P = run_pointers(o_ism, o_dist, base, out_lens, S)
    P = torch.clamp(P, 0, T).to(torch.int64)

    Pf = torch.cat([torch.arange(CTX, dtype=torch.int64, device=dev),
                    P.reshape(-1),
                    torch.tensor([T], dtype=torch.int64, device=dev)])
    Pf = double_pointers(Pf)
    out = init[Pf][CTX:T]
    return out.to(torch.uint8), err


# ---------------------------------------------------------------------------
# Batched device decode
# ---------------------------------------------------------------------------

def decode_batch(comp, clen, start, lims_ll, kbase_ll, syms_ll,
                 lims_d, kbase_d, syms_d, out_lens, ctx0, *,
                 S: int, NS: int, hist_len: int = CTX,
                 end_bit: bool = False):
    """Serial-walk decode of a batch of shards: (output, err, counts), and
    with end_bit=True the bit (B,) where each row's walk ends (after its
    first end-of-block, when it has one)."""
    STATS["decode_batch"] += 1
    with metrics.span("decode.pass1"):
        word = _pass1(comp, lims_ll, kbase_ll, syms_ll, lims_d, kbase_d,
                      syms_d)
    with metrics.span("decode.walk"):
        words, counts = _walk(word, start, 8 * clen, NS)
    with metrics.span("decode.resolve"):
        out, err = _resolve(words, counts, out_lens, ctx0, S, hist_len)
    if end_bit:
        slots = torch.arange(NS, dtype=torch.int32, device=words.device)
        adv = torch.where(slots[None, :] < counts[:, None], words & 63, 0)
        return out, err, counts, start + adv.sum(dim=1, dtype=torch.int32)
    return out, err, counts


def _pack_flags(err, *rest):
    """One fetched tensor for the per-batch flags (err, spec_fail) and any
    further per-row results, as int32: each fetch blocks the host until
    the device has caught up."""
    return torch.stack([t.to(torch.int32) for t in (err, *rest)])


def _bucket(c: int) -> int:
    b = 8192
    while b < c:
        b *= 2
    return b


def walk_mode(walk: str | None) -> str:
    """The walk an entry point uses: its `walk` argument, or else the
    environment's FLATE_TPU_INFLATE_WALK read now, or else "lanes"."""
    if walk is None:
        walk = os.environ.get("FLATE_TPU_INFLATE_WALK", "lanes")
    if walk not in ("lanes", "serial"):
        raise ValueError(f"walk must be 'lanes' or 'serial', got {walk!r}")
    return walk


def _host_decode_shard(sh: bytes, out_len: int, hist: bytes) -> bytes:
    """Exact host decode of one shard, block by block in pure Python
    (non-final shards end in a sync flush, not BFINAL: the indexed output
    size bounds the loop).  The decode path does not call it — an unproven
    batch is walked again serially on the device; it is the host oracle
    for one shard's bytes."""
    bits = hinf._BitCursor(sh)
    outb = bytearray(hist)
    base = len(outb)
    while len(outb) - base < out_len:
        bits.read(1)                       # bfinal (budget-bounded)
        btype = bits.read(2)
        if btype == 0:
            hinf._decode_stored(bits, outb)
        elif btype == 1:
            ll, dd = hinf.fixed_tables()
            hinf._decode_coded_block(bits, outb, ll, dd)
        elif btype == 2:
            ll, dd = hinf._decode_dynamic_header(bits)
            hinf._decode_coded_block(bits, outb, ll, dd)
        else:
            raise InvalidBlockType()
    return bytes(outb[base:base + out_len])


class _Reroute(Exception):
    """Internal: the shard-parallel path cannot decode the member as its
    FLT1 index describes it (segmented multi-block shards, or a stream the
    index does not hold for); re-route it to the chained device path, with
    the index's shard offsets as chain entries."""


def _tail_ok(sh: bytes, bit: int, final: bool, last: bool) -> bool:
    """Whether shard `sh` holds nothing the index does not count after its
    data, which ends at `bit` (its coded block's end-of-block, or its last
    stored block's bytes): only empty stored blocks (sync markers) up to
    its last byte, and a final block exactly where the member ends — the
    last block of the last shard, and none before.  `final` is the final
    bit of the block that ends at `bit`.  What the serial decode reads
    there is then what the indexed route assumed."""
    if final:
        return last and (bit + 7) >> 3 == len(sh)
    n = 8 * len(sh)
    bits = hinf._BitCursor(sh, bit)
    try:
        while bits.pos < n:
            bfinal = bits.read(1)
            if bits.read(2) != 0:
                return False
            bits.align_to_byte()
            if bits.read(16) != 0 or bits.read(16) != 0xFFFF:
                return False
            if bfinal:
                return last and bits.pos == n
    except EndOfStream:
        return False
    return not last


def decompress_member_device(data: bytes, offset: int,
                             container: Container = Container.GZIP,
                             batch: int = 8, verify: bool = True, *,
                             device: str | torch.device = "cuda",
                             walk: str | None = None):
    """Decode one indexed member starting at `offset`.

    Returns (bytes, next_offset).  Raises LookupError when the member
    carries no usable FLT1 index.  Members with segmented shards
    (intra-shard stored/coded block mix) re-decode through
    device/anyinflate.py's chained path on the same device, with the
    index's shard offsets as exact chain entries.

    The index is a hint, not the truth: whatever fails on the indexed
    route (a shard's plan, its decode, bits of a shard the index does not
    count, the footer at the index's end) re-routes the member, once, to
    the chained path, which reads the body as the serial decode does and
    raises its verdict.  A member the index holds for is decoded once."""
    dev = resolve_device(device)
    walk = walk_mode(walk)
    try:
        return _decompress_member_indexed(data, offset, container, batch,
                                          dev, walk, verify)
    except (_Reroute, FlateError):
        from . import anyinflate
        STATS["segmented_reroutes"] += 1
        hdr_len, meta = parse_header(container, data[offset:])
        comp_lens, _out_lens, _flags = parse_index_extra(meta.extra)
        starts = np.concatenate([[0], np.cumsum(comp_lens)[:-1]])
        entries = [8 * int(s) for s in starts]
        return anyinflate._decompress_member_any(
            data, offset, container, verify, dev, entries=entries)


def args_from_numpy(args, device: str | torch.device):
    """The eleven arrays of a pack_coded_run tuple (comp, clen, start,
    lims_ll, kbase_ll, syms_ll, lims_d, kbase_d, syms_d, out_lens, ctx0),
    given as numpy arrays, as this module's tensors on `device`: the u32
    limits as int64, the bytes as uint8, the rest as int32."""
    out = []
    for a in args:
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out.append(torch.tensor(a, device=device))
    return tuple(out)


def pack_coded_run(plans_run, hist: bytes,
                   device: str | torch.device = "cpu"):
    """Pack a member-consecutive run of coded shard plans into the
    decode_batch(2) argument tuple, as tensors on `device`: padded comp
    grid, per-row meta, Moffat-Turpin threshold scalars, and the shared
    32 KiB context."""
    cmax = _bucket(max(len(sh) for _, sh in plans_run))
    Bc = len(plans_run)
    comp_a = np.zeros((Bc, cmax), np.uint8)
    meta = np.zeros((Bc, 3), np.int32)
    sc_ll = np.zeros((Bc, 16), np.uint32)
    sc_d = np.zeros((Bc, 16), np.uint32)
    kb_ll = np.zeros((Bc, 16), np.int32)
    kb_d = np.zeros((Bc, 16), np.int32)
    sy_ll = np.zeros((Bc, 288), np.int32)
    sy_d = np.zeros((Bc, 32), np.int32)
    for bi, (p2, sh2) in enumerate(plans_run):
        comp_a[bi, :len(sh2)] = np.frombuffer(sh2, np.uint8)
        meta[bi] = (len(sh2), p2.start_bit, p2.out_len)
        sc_ll[bi], kb_ll[bi], sy_ll[bi] = p2.ll
        sc_d[bi], kb_d[bi], sy_d[bi] = p2.d
    ctx0 = np.zeros(CTX, np.uint8)
    if hist:
        ctx0[CTX - len(hist):] = np.frombuffer(hist, np.uint8)
    return args_from_numpy(
        (comp_a, meta[:, 0], meta[:, 1], sc_ll, kb_ll, sy_ll,
         sc_d, kb_d, sy_d, meta[:, 2], ctx0), device)


def _decompress_member_indexed(data: bytes, offset: int,
                               container: Container, batch: int,
                               dev: torch.device, walk: str, verify: bool):
    with metrics.span("decode.index"):
        hdr_len, meta = parse_header(container, data[offset:])
        if meta is None or meta.extra is None:
            raise LookupError("no FLT1 index")
        idx = parse_index_extra(meta.extra)
        if idx is None:
            raise LookupError("no FLT1 index")
    comp_lens, out_lens, _flags = idx
    body = offset + hdr_len
    starts = body + np.concatenate([[0], np.cumsum(comp_lens)[:-1]])
    total_comp = int(comp_lens.sum())

    S = int(out_lens.max()) if len(out_lens) else 1
    S = max(-(-S // 1024) * 1024, 1024)
    if S > 1 << 17:
        # the encoder writes <= 128K shards; a larger (foreign/hostile)
        # index exceeds the packed-field bound in _resolve
        raise LookupError("FLT1 shards too large for device decode")
    NS = S + 128
    n = len(comp_lens)
    out = bytearray()
    hasher = Hasher(container)

    i = 0
    while i < n:
        nb = min(batch, n - i)
        plans = []
        with metrics.span("decode.plan", shards=nb):
            for j in range(i, i + nb):
                sh = data[starts[j]:starts[j] + int(comp_lens[j])]
                plans.append((plan_shard(sh, int(out_lens[j])), sh))
        # process shards strictly in member order: stored shards flush
        # to `out` on host (pure memcpy); consecutive runs of coded
        # shards dispatch together with ctx0 taken from the already-
        # flushed history, so back-references across a preceding stored
        # shard resolve against real bytes (batch rows must be
        # member-consecutive for in-batch back-references)
        j = 0
        while j < nb:
            p, sh = plans[j]
            if p.kind == "stored":
                buf = b"".join(sh[off:off + ln] for off, ln in p.stored_spans)
                if len(buf) != p.out_len or p.end_bit > 8 * len(sh) \
                        or not _tail_ok(sh, p.end_bit, p.end_final,
                                        i + j == n - 1):
                    raise _Reroute()
                out += buf
                hasher.update(buf)
                j += 1
                continue
            if p.kind == "mixed":
                raise _Reroute()
            k = j
            while k < nb and plans[k][0].kind == "coded":
                k += 1
            run = plans[j:k]
            hist = bytes(out[-CTX:])
            run_attrs = {"shards": len(run),
                         "coded_bytes": sum(len(sh2) for _, sh2 in run)}
            with metrics.span("decode.upload", **run_attrs):
                args = pack_coded_run(run, hist, dev)

            def serial():
                """The run by the exact serial walk: (output, err, end
                bits), the last two fetched in one go."""
                dev_out, err, _, end = decode_batch(
                    *args, S=S, NS=NS, hist_len=len(hist), end_bit=True)
                with metrics.span("decode.flags"):
                    return (dev_out, *_pack_flags(err, end).cpu().numpy())

            if walk == "serial":
                with metrics.span("decode.batch", walk=walk, **run_attrs):
                    dev_out, err_np, end_np = serial()
            else:
                with metrics.span("decode.batch", walk=walk, **run_attrs):
                    dev_out, err, _, spec_fail, end = decode_batch2(
                        *args, S=S, NS=NS, hist_len=len(hist), end_bit=True)
                with metrics.span("decode.flags"):
                    err_np, spec_np, end_np = _pack_flags(
                        err, spec_fail, end).cpu().numpy()
                if spec_np.any():
                    # lane speculation unproven for some shard — most
                    # often the lane that holds the EOB, when the block
                    # ends before that lane's chains meet.  Walk the run
                    # again with the exact serial walk, on the same
                    # device: correctness never depends on the
                    # speculative path
                    STATS["serial_retries"] += 1
                    with metrics.span("decode.retry", **run_attrs):
                        dev_out, err_np, end_np = serial()
            # a coded-first shard with MORE blocks after its first EOB
            # (segmented) decodes short and poisons in-batch
            # back-references, and a shard may hold bits after its block
            # that the index does not count: re-decode the member on the
            # chained device path, which raises the exact taxonomy of a
            # genuinely corrupt stream (a match before the member's start
            # too)
            if err_np.any() or not all(
                    _tail_ok(sh2, int(end_np[bi]), p2.final,
                             i + j + bi == n - 1)
                    for bi, (p2, sh2) in enumerate(run)):
                raise _Reroute()
            with metrics.span("decode.fetch", **run_attrs):
                out_np = dev_out.cpu().numpy().reshape(len(run), S)
                rows = [out_np[bi, :p2.out_len].tobytes()
                        for bi, (p2, _) in enumerate(run)]
                for r in rows:
                    out += r
            with metrics.span("decode.checksum"):
                for r in rows:
                    hasher.update(r)
            j = k
        i += nb

    foot_off = body + total_comp
    with metrics.span("decode.checksum"):
        if verify:
            foot_len = parse_footer(container, data[foot_off:], hasher)
        else:
            foot_len = container.footer_size
            if len(data) < foot_off + foot_len:
                raise EndOfStream("footer truncated")
    return bytes(out), foot_off + foot_len


def decompress_device(data: bytes,
                      container: Container = Container.GZIP,
                      batch: int = 8, *,
                      device: str | torch.device = "cuda",
                      walk: str | None = None) -> bytes:
    """Device decode of a stream of indexed members, in batches of `batch`
    shards; a member without the FLT1 index raises LookupError.
    walk="lanes" (the default, or the environment's FLATE_TPU_INFLATE_WALK)
    uses the lane walk, "serial" the exact serial walk."""
    dev = resolve_device(device)
    walk = walk_mode(walk)
    with metrics.timed("device.decompress_indexed", len(data)) as m:
        out = bytearray()
        offset = 0
        while offset < len(data):
            chunk, offset = decompress_member_device(
                data, offset, container, batch=batch, device=dev, walk=walk)
            out += chunk
        m["bytes_out"] = len(out)
    return bytes(out)
