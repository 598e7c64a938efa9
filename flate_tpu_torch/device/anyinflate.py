"""Device inflate of ARBITRARY deflate streams — no FLT1 index needed.

Counterpart of flate_tpu/jx/anyinflate.py:

1. **Chain entries**: block-header bit positions of the member body.  A
   member re-routed from the indexed path brings its shard offsets, one
   exact entry per shard.  A foreign stream gets bit 0 and, for each
   further chunk of `chunk_bytes`, the first validated dynamic-block
   header the chunk-entry scanner finds there (device/scan.py, one kernel
   launch for the member).  Such an entry is speculative: a header inside
   a stored block's payload (a deflate stream stored as data) passes the
   scanner too.  A block that fails to parse or decode raises only once
   the chain from bit 0 reaches it, so a false entry's garbage chain
   costs rounds, never the result.  (The JAX package raises at the first
   failure of any chain, also on such streams that zlib decodes.)
2. **Chained block decode** (device): each round decodes one row (a
   block, or a continuation row of a long one) per active chain position
   — pass1 speculative symbol decode over the row's span, multi-lane
   walk with join resolve (device/inflate2.py), symbol compaction with
   EOB discovery.  The EOB gives the exact bit
   position of the NEXT block header, which the host parses (tiny) and
   queues for the next round, so all chains advance concurrently.
3. **LZ resolution in stream order** (device): the chain's blocks are
   batched consecutively and resolved with a COMPACT output layout (rows
   at cumulative offsets, so cross-block back-references inside a batch
   land on real bytes) and a 32 KiB context carry between batches.
   Stored blocks are raw byte spans flushed from the host.  The context
   holds only real history (a preset dictionary, then the member's
   output): a match that reaches before it raises InvalidMatch.
4. **Streaming steps** (`decode_step`): the same chained decode over a
   window of a longer member, with the history carried from the step
   before.  A block that runs off the window is not dropped: its rows up
   to the window's end are decoded and resolved (a coded block up to the
   end of its last whole symbol, a stored block's payload up to the
   window's last byte), and the step hands the block on (a carry: its
   decode tables, or the rest of its stored length), so the next step
   starts inside it.  A step's input is the window, whatever the blocks'
   lengths (api.Decompressor).  Its resolve is lazy (Resolve): the
   chain's symbols wait on the device and are resolved a batch of at most
   `out_cap` output bytes at a time, as the reader takes them, so the
   output a step holds is one batch, whatever the member's ratio.

Correctness never depends on speculation: join failures re-decode the
row with the exact serial walk; a block's first span escalates from SPAN0
until its EOB lies in it, and a block that still has none at MAX_SPAN goes
on in continuation rows from the end of the row's last whole symbol, so a
block of any compressed length decodes; what still fails raises.  A block
that runs off the end of the body (no EOB up to the last bit, and no
invalid code wholly before it), an EOB past the last bit, or a chain that
reaches the end of the body before its final block raises EndOfStream, as
the JAX package's public decode does for a truncated stream; an invalid
code raises InvalidCode.  (The JAX device function stops escalating at
MAX_SPAN and fails such a block; its public decode reads it on the host.)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import consts, metrics, tables
from .. import inflate as hinf
from ..containers import Container, Hasher, parse_footer, parse_header
from ..errors import (
    EndOfStream,
    FlateError,
    InvalidBlockType,
    InvalidCode,
    InvalidMatch,
    WrongStoredBlockNlen,
)
from . import inflate2 as i2
from . import resolve_device, scan

CTX = consts.MAX_DISTANCE

CHUNK_BYTES = 1 << 19            # chain spacing of the chunk-entry scanner
SPAN0 = 1 << 16                  # a block's first span (64 KiB comp)
# the compressed bytes of a row: a block's first span escalates to it, a
# continuation row takes it at once.  It bounds a row, not a block: a
# longer block decodes in rows of at most this many bytes, so pass 1 of a
# row holds at most 2^24 positions and its bit offsets fit int32
MAX_SPAN = 1 << 21
RES_B = 8                        # resolve batch rows
MAX_S = 1 << 22                  # output bytes of a resolve row
# bit positions one symbol_batch call may hold: pass 1 makes a few dozen
# int32 temporaries of this many elements, so a round's rows go through
# in chunks (two rows of MAX_SPAN a call)
MAX_POSITIONS = 1 << 25
# the longest symbol: a 15-bit length code, 5 extra bits, a 15-bit
# distance code and 13 extra bits
MAX_SYMBOL_BITS = 48
_EOB_WORD = i2.K_EOB << 6        # the end-of-block a resolve row ends with


# ---------------------------------------------------------------------------
# Host-side block planning at an exact bit position
# ---------------------------------------------------------------------------

class BlockPlan:
    """One row of the chained decode: a block from its header at bit
    `pos` ("stored" or "coded"), or a row that goes on with a block begun
    before it: a continuation row of a coded block ("cont"), which starts
    at bit `pos` on a symbol boundary, or the rest of a stored block's
    payload ("rest"), from the byte at bit `pos`.  `block` is the bit of
    the block's header, negative where it lies before the window."""
    __slots__ = ("kind", "pos", "block", "bfinal", "body_bit", "ll", "d",
                 "lens", "stored_off", "stored_len", "end_bit")

    def key(self):
        """The row's key in a chain: its header bit, or (bit, header bit)
        for a row inside a block, whose bit may also be a chain entry."""
        return self.pos if self.kind in ("stored", "coded") \
            else (self.pos, self.block)


def plan_block_at(body: bytes, pos: int, *, partial: bool = False
                  ) -> BlockPlan:
    """Parse ONE block header at exact bit `pos` (host, tiny).

    stored blocks are fully resolved here (end_bit known); coded blocks
    get canonical decode scalars and decode on device.  A stored block
    whose payload runs past the end of `body` raises EndOfStream, unless
    `partial` (more input may come: its end_bit then lies past the end)."""
    p = BlockPlan()
    p.pos = p.block = pos
    bits = hinf._BitCursor(body, pos)
    p.bfinal = bits.read(1)
    btype = bits.read(2)
    if btype == 0:
        bits.align_to_byte()
        ln = bits.read(16)
        nlen = bits.read(16)
        if (ln ^ nlen) & 0xFFFF != 0xFFFF:
            raise WrongStoredBlockNlen("stored LEN/NLEN mismatch")
        p.kind = "stored"
        p.stored_off = bits.pos >> 3
        p.stored_len = ln
        if p.stored_off + ln > len(body) and not partial:
            raise EndOfStream("stored block past end")
        p.end_bit = (p.stored_off + ln) * 8
        return p
    if btype == 1:
        ll_lens = np.asarray(tables.FIXED_LITLEN_LENS, np.int32)
        d_lens = np.asarray(tables.FIXED_DIST_LENS, np.int32)
        p.lens = None
    elif btype == 2:
        ll_lens, d_lens = hinf.decode_dynamic_header_lens(bits)
        hinf.check_completeness(ll_lens, consts.MAX_CODE_BITS, True)
        hinf.check_completeness(d_lens, consts.MAX_CODE_BITS, False)
        p.lens = (ll_lens, d_lens)
    else:
        raise InvalidBlockType(f"block type {btype}")
    p.kind = "coded"
    p.body_bit = bits.pos
    p.ll = i2.canonical_scalars(ll_lens, 288)
    p.d = i2.canonical_scalars(d_lens, 32)
    return p


def plan_continuation(p: BlockPlan, bit: int) -> BlockPlan:
    """The row after coded row `p`, which reached MAX_SPAN bytes without
    its end-of-block: the same block and decode tables from `bit`, the end
    of p's last whole symbol; no header."""
    q = BlockPlan()
    q.kind = "cont"
    q.pos = q.body_bit = bit
    q.block, q.bfinal, q.ll, q.d, q.lens = p.block, p.bfinal, p.ll, p.d, \
        p.lens
    return q


def plan_rest(p: BlockPlan, bit: int, n: int) -> BlockPlan:
    """The last `n` bytes of stored block p's payload, from byte-aligned
    `bit`: what a window that ends inside the payload leaves over."""
    q = BlockPlan()
    q.kind = "rest"
    q.pos, q.block, q.bfinal = bit, p.block, p.bfinal
    q.stored_off, q.stored_len = bit >> 3, n
    q.end_bit = bit + 8 * n
    return q


def moved(p: BlockPlan, bits: int) -> BlockPlan:
    """Row p inside a block ("cont" or "rest") in a window that starts
    `bits` (a multiple of 8) later."""
    if p.kind == "rest":
        q = plan_rest(p, p.pos - bits, p.stored_len)
    else:
        q = plan_continuation(p, p.pos - bits)
    q.block = p.block - bits
    return q


def _where(p: BlockPlan) -> str:
    return f"block at bit {p.block}" if p.block >= 0 \
        else "block begun before the window"


def stop_error(body: bytes, p: BlockPlan, bit: int) -> FlateError:
    """The error of the symbol at `bit` of coded row `p`, where its chain
    stopped without an end-of-block at the end of the body: that one
    symbol decoded on the host with the block's tables, as the serial
    decode meets it.  InvalidCode for a code the tables do not hold (the
    bits past the body read as zeros, as they do there), EndOfStream when
    the body ends inside the symbol or its extra bits; each in the order
    the serial decode checks them.  No payload is decoded here."""
    if p.lens is None:
        ll, d = hinf.fixed_tables()
    else:
        ll = hinf.build_decode_table(p.lens[0], consts.MAX_CODE_BITS, True)
        d = hinf.build_decode_table(p.lens[1], consts.MAX_CODE_BITS, False)
    try:
        hinf.read_symbol(hinf._BitCursor(body, bit), ll, d)
    except (InvalidCode, EndOfStream) as e:
        return type(e)(f"{_where(p)}: symbol at bit {bit}")
    raise RuntimeError(f"{_where(p)}: the walk stopped at bit {bit} on a "
                       f"whole symbol")


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------

def symbol_batch(comp, clen, start, lims_ll, kbase_ll, syms_ll,
                 lims_d, kbase_d, syms_d, *, NS: int,
                 G: int = i2.LANE_G, serial: bool = False, cut: bool = True):
    """Span bytes -> compacted true symbols (stay on device).

    Returns (words (B, NS), counts, spec_fail, has_eob, out_len,
    end_bit).  serial=True uses the exact one-symbol-per-step walk
    (retry path for join failures).

    A row whose end-of-block does not end inside its span (clen bytes)
    reports its cut instead (inflate2._cut): counts, out_len and end_bit
    of its whole symbols, with no end-of-block among them, and spec_fail
    when its chain is unproven up to the cut.  The next row of the block
    starts at that end bit.  cut=False skips the cut (such a row keeps
    what its walk gives): for rows that only escalate their span."""
    word = i2._pass1(comp, lims_ll, kbase_ll, syms_ll,
                     lims_d, kbase_d, syms_d)
    nbits = 8 * clen
    slots = torch.arange(NS, dtype=torch.int32, device=word.device)[None, :]
    if serial:
        # the serial walk already emits compacted words + counts; the
        # extras of _extract are recomputed from them
        words, counts = i2._walk(word, start, nbits, NS)
        kind = (words >> 6) & 3
        live = slots < (counts[:, None] - 1)
        value = (words >> 8) & 0xFF
        olen = torch.where(live & (kind == i2.K_MATCH), value + 3,
                           (live & (kind == i2.K_LIT)).to(torch.int32))
        out_len = olen.sum(dim=1).to(torch.int32)
        last = torch.gather(
            words, 1,
            torch.clamp(counts - 1, min=0).to(torch.int64)[:, None])[:, 0]
        has_eob = (counts >= 1) & (((last >> 6) & 3) == i2.K_EOB)
        # end bit: the serial walk stops AT the EOB; its position is the
        # start plus the advances of the walked symbols
        adv = torch.where(slots < counts[:, None], words & 63, 0)
        end_bit = start.to(torch.int32) + adv.sum(dim=1).to(torch.int32)
        fail = torch.zeros_like(has_eob)
        joined = mask = None
    else:
        mask, joined = i2._lane_walk(word, start, nbits, G=G)
        words, counts, fail, has_eob, out_len, end_bit = i2._extract(
            word, mask, joined, start, NS, G)
        kind = (words >> 6) & 3
    # an end-of-block counts only where the chain reaches it whole: none
    # after an invalid code, none that runs past the span (decoded from the
    # zeros after it)
    has_eob = has_eob & (end_bit <= nbits) & ~(
        (kind == i2.K_BAD) & (slots < counts[:, None] - 1)).any(dim=1)
    # the cut of the rows without one: one fetch of their indices, so a
    # round whose rows all end their blocks pays nothing more
    rows = torch.nonzero(~has_eob)[:, 0] if cut else ()
    if len(rows):
        n = counts[rows] if mask is None else mask[rows].sum(
            dim=1, dtype=torch.int32)
        cuts = i2._cut(words[rows], n, start[rows], nbits[rows],
                       None if joined is None else joined[rows], G)
        counts, out_len, end_bit, fail = (
            t.index_copy(0, rows, c.to(t.dtype))
            for t, c in zip((counts, out_len, end_bit, fail), cuts))
    return words, counts, fail, has_eob, out_len, end_bit


def resolve_compact(words, counts, out_lens, ctx0, *, S: int,
                    hist_len: int = CTX):
    """Parallel LZ resolution with COMPACT row placement.

    words (B, NS) compacted symbols of CONSECUTIVE blocks; row b's
    output occupies [CTX + prefix(out_lens)[b], ... + out_lens[b]) of a
    flat buffer, so back-references cross rows exactly like the
    original stream (variable-size blocks — unlike inflate2._resolve
    whose rows sit at a fixed stride).  The last `hist_len` bytes of ctx0
    are real history; a match that reaches before them is an error.
    Returns (flat (B*S,) u8 whose first sum(out_lens) bytes are the
    stream, err (B,))."""
    B, NS = words.shape
    dev = words.device
    out_lens = out_lens.to(torch.int32)
    live, is_m, is_l, value, dist, offs, err = i2.symbol_fields(
        words, counts, out_lens)

    base = CTX + (torch.cumsum(out_lens, dim=0, dtype=torch.int32)
                  - out_lens)[:, None]
    T = CTX + B * S
    # literal placement (buffer positions are already compact); slot T
    # is the sink
    lit_pos = torch.where(is_l & (base + offs < T), base + offs, T)
    init = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    init[lit_pos.reshape(-1).to(torch.int64)] = value.reshape(-1)
    init[:CTX] = ctx0.to(torch.int32)

    o_ism, o_dist = i2.propagate_match_fields(live, is_m, offs, dist, S)
    # a match's leftmost source byte is base + offs - dist
    err = err + (is_m & (base + offs - dist < CTX - hist_len)).sum(dim=1)
    glob, in_range, P = i2.run_pointers(o_ism, o_dist, base, out_lens, S)
    P = torch.clamp(P, 0, T).to(torch.int64)

    # compact (row, pos_in) -> buffer order: the buffer positions of the
    # in-range bytes are unique and dense, so each byte's pointer goes
    # straight to its own position; bytes past the rows' outputs point at
    # themselves
    Pf = torch.arange(T + 1, dtype=torch.int64, device=dev)
    key = torch.where(in_range, glob, T).reshape(-1).to(torch.int64)
    Pf[key] = P.reshape(-1)
    Pf[T] = T
    Pf = i2.double_pointers(Pf)
    out = init[Pf][CTX:T]
    return out.to(torch.uint8), err


def _pieces(words: torch.Tensor, out_len: int, cap: int | None = None
            ) -> list:
    """One block's symbols (words (counts,), the end-of-block last) as
    resolve rows (words, counts, out_len) of at most `cap` (default
    MAX_S) output bytes each, cut at symbol boundaries: the symbols that
    start in each cap - 257 bytes of the block's output, so a row holds at
    most cap - 258 + 258 bytes.  A row that does not end at the block's
    end gets an end-of-block word of its own (symbol_fields wants one at
    counts - 1).  A match of a later row reaches back into the earlier
    rows of its batch or into the context carried from the batch
    before, like a match across blocks."""
    cap = MAX_S if cap is None else cap
    n = words.shape[0]
    if out_len <= cap:
        return [(words, n, out_len)]
    kind = (words >> 6) & 3
    olen = torch.where(kind == i2.K_MATCH, ((words >> 8) & 0xFF) + 3,
                       (kind == i2.K_LIT).to(torch.int32))
    starts = torch.cumsum(olen, dim=0) - olen
    targets = torch.arange(cap - 257, out_len, cap - 257,
                           dtype=starts.dtype, device=words.device)
    cuts = torch.searchsorted(starts, targets)
    cut_np, at_np = torch.stack([cuts, starts[cuts]]).cpu().numpy()
    eob = torch.full((1,), _EOB_WORD, dtype=words.dtype,
                     device=words.device)
    bounds = [0, *cut_np.tolist(), n]
    offs = [0, *at_np.tolist(), out_len]
    rows = []
    for j in range(len(bounds) - 1):
        a, b = bounds[j], bounds[j + 1]
        w = words[a:b] if b == n else torch.cat([words[a:b], eob])
        rows.append((w, w.shape[0], offs[j + 1] - offs[j]))
    i2.STATS["block_pieces"] += len(rows)
    return rows


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

def _pack_meta(counts, fail, has_eob, out_len, end_bit):
    """One fetched tensor for the five per-row results of a group.
    end_bit is relative to the row's first byte and no row spans more than
    MAX_SPAN bytes (2 MiB: 2^24 bits), so int32 is safe whatever the
    body's length; the host adds the row's byte offset as a Python int."""
    return torch.stack([
        counts.to(torch.int32), fail.to(torch.int32),
        has_eob.to(torch.int32), out_len.to(torch.int32),
        end_bit.to(torch.int32)])


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _decode_round(body: bytes, plans: list, span: dict,
                  serial_set: set, dev: torch.device) -> dict:
    """Decode one row per plan on device; returns key -> result dict
    with (words ref, row, counts, out_len, end_bit, has_eob, ok), keyed by
    BlockPlan.key.  A block's first row spans span[key] bytes (SPAN0 until
    it escalates), a continuation row MAX_SPAN, neither past the body.  A
    row of a C-byte span has 8 C symbol slots: a symbol takes at least one
    bit, so the chain always fits, however short its symbols."""
    groups: dict = {}
    for p in plans:
        byte0 = p.pos >> 3
        cap = span.get(p.key(), MAX_SPAN if p.kind == "cont" else SPAN0)
        C = _bucket(min(len(body) - byte0, cap), 8192)
        key = (C, p.key() in serial_set)
        groups.setdefault(key, []).append((p, byte0))
    results = {}
    for (C, serial), grp in groups.items():
        rows = max(1, MAX_POSITIONS // (8 * C))
        for lo in range(0, len(grp), rows):
            part = grp[lo:lo + rows]
            Bc = len(part)
            comp = np.zeros((Bc, C), np.uint8)
            clen = np.zeros(Bc, np.int32)
            start = np.zeros(Bc, np.int32)
            sc_ll = np.zeros((Bc, 16), np.uint32)
            kb_ll = np.zeros((Bc, 16), np.int32)
            sy_ll = np.zeros((Bc, 288), np.int32)
            sc_d = np.zeros((Bc, 16), np.uint32)
            kb_d = np.zeros((Bc, 16), np.int32)
            sy_d = np.zeros((Bc, 32), np.int32)
            for bi, (p, byte0) in enumerate(part):
                sl = body[byte0:byte0 + C]
                comp[bi, :len(sl)] = np.frombuffer(sl, np.uint8)
                clen[bi] = len(sl)
                start[bi] = p.body_bit - 8 * byte0
                sc_ll[bi], kb_ll[bi], sy_ll[bi] = p.ll
                sc_d[bi], kb_d[bi], sy_d[bi] = p.d
            # a row without its end-of-block needs its cut only where it
            # does not just escalate: at MAX_SPAN or the body's end
            cut = C >= MAX_SPAN or any(byte0 + C >= len(body)
                                       for _, byte0 in part)
            words, counts, fail, has_eob, out_len, end_bit = symbol_batch(
                *i2.args_from_numpy((comp, clen, start, sc_ll, kb_ll, sy_ll,
                                     sc_d, kb_d, sy_d), dev),
                NS=8 * C, serial=serial, cut=cut)
            # the word at slot `counts`: what stopped a row without its
            # end-of-block, fetched with the rest
            stop = torch.gather(words, 1, torch.clamp(
                counts, max=8 * C - 1).to(torch.int64)[:, None])[:, 0]
            meta_np = torch.cat([
                _pack_meta(counts, fail, has_eob, out_len, end_bit),
                stop[None].to(torch.int32)]).cpu().numpy()
            cn_np, fail_np, eob_np, ol_np, eb_np, stop_np = meta_np
            # keep the rows' symbols, not their 8 C slots (a copy: a view
            # would hold them all): a step holds its rows until the resolve
            words = words[:, :int(cn_np.max())].clone()
            for bi, (p, byte0) in enumerate(part):
                results[p.key()] = {
                    "words": words, "row": bi, "plan": p,
                    "counts": int(cn_np[bi]),
                    "out_len": int(ol_np[bi]),
                    "end_bit": 8 * byte0 + int(eb_np[bi]),
                    "has_eob": bool(eob_np[bi]),
                    "ok": not bool(fail_np[bi]),
                    "serial": serial,
                    "span": C,
                    "cut": cut,
                    "stop": int(stop_np[bi]),
                }
    return results


def _invalid_code_at_cut(r: dict, span_end: int) -> bool:
    """Whether the word that stopped a coded row without its end-of-block
    at its cut (end_bit) is an invalid code (K_BAD) that lies wholly
    before the row's last bit `span_end`: the block's own error, which
    more bits cannot mend.  Otherwise the row was cut by its span's end,
    or stopped within a symbol of the body's end (stop_error decides)."""
    return ((r["stop"] >> 6) & 3) == i2.K_BAD \
        and r["end_bit"] + MAX_SYMBOL_BITS <= span_end


def _reaches_before(rows: list, hist_len: int) -> bool:
    """Whether a match of the chain's rows, in stream order, reaches before
    the `hist_len` bytes of history: resolve_compact's test, made on the
    symbols alone (no bytes are resolved).  A row gives its first `counts`
    words, a stored block its length.  One fetch for all the rows."""
    base, hits = 0, []
    for r in rows:
        if not r["stored"] and r["counts"]:
            w = r["words"][r["row"], :r["counts"]]
            kind = (w >> 6) & 3
            is_m = kind == i2.K_MATCH
            olen = torch.where(is_m, ((w >> 8) & 0xFF) + 3,
                               (kind == i2.K_LIT).to(torch.int32))
            offs = torch.cumsum(olen, dim=0) - olen
            dist = ((w >> 16) & 0x7FFF) + 1
            hits.append((is_m & (base + offs - dist < -hist_len)).any())
        base += r["out_len"]
    return bool(torch.stack(hits).any()) if hits else False


def decompress_device_any(data: bytes,
                          container: Container = Container.GZIP,
                          verify: bool = True, *,
                          chunk_bytes: int = CHUNK_BYTES,
                          device: str | torch.device = "cuda") -> bytes:
    """Device decode of an arbitrary (unindexed) stream of one or more
    concatenated members, each as chains from bit 0 and from the chunk
    entries the scanner finds every `chunk_bytes` of its body.  Bytes
    after a member are read as the next member, as the JAX package's
    public decode reads them: trailing bytes that are not one raise its
    error."""
    dev = resolve_device(device)
    with metrics.timed("device.decompress_any", len(data)) as m:
        out = bytearray()
        offset = 0
        while offset < len(data):
            chunk, offset = _decompress_member_any(
                data, offset, container, verify, dev,
                chunk_bytes=chunk_bytes)
            out += chunk
        m["bytes_out"] = len(out)
    return bytes(out)


def history(dictionary: bytes | None) -> bytes:
    """The history a member starts with: the last CTX bytes of its preset
    dictionary, or none.  Its length is the bytes of real history."""
    return bytes(dictionary[-CTX:]) if dictionary else b""


def _decompress_member_any(data: bytes, offset: int,
                           container: Container, verify: bool,
                           dev: torch.device, *,
                           chunk_bytes: int = CHUNK_BYTES,
                           entries: list | None = None,
                           dictionary: bytes | None = None):
    """Decode the member at byte `offset`; returns (bytes, the offset
    after its footer).

    `entries` gives KNOWN block-header bit positions (relative to the
    member body) as chain heads — e.g. the per-shard offsets of an FLT1
    index, which make every chain exact.  None scans the body for one
    entry per chunk of `chunk_bytes` (scan.chunk_entries).  `dictionary`
    is the preset history: a zlib header may then carry FDICT."""
    i2.STATS["chained_members"] += 1
    hdr_len, _meta = parse_header(container, data[offset:],
                                  allow_dict=dictionary is not None)
    body = data[offset + hdr_len:]
    if entries is None:
        entries = scan.chunk_entries(body, chunk_bytes, device=dev)
    hist = history(dictionary)
    chain, end_bit, _done, _ = _chain(body, entries, 0, dev,
                                      hist_len=len(hist))
    out = bytearray()
    for part in Resolve(chain, body, hist, dev):
        out += part

    foot_off = offset + hdr_len + ((end_bit + 7) // 8)
    hasher = Hasher(container)
    if verify:
        hasher.update(bytes(out))
        foot_len = parse_footer(container, data[foot_off:], hasher)
    else:
        foot_len = container.footer_size
        if len(data) < foot_off + foot_len:
            raise EndOfStream("footer truncated")
    return bytes(out), foot_off + foot_len


def decode_step(window: bytes, start: int, hist: bytes, *,
                final_input: bool, carry: BlockPlan | None = None,
                entries: list | None = None,
                chunk_bytes: int = CHUNK_BYTES, chain_cap: int | None = None,
                out_cap: int | None = None,
                device: str | torch.device = "cuda"):
    """One step of a streaming decode: the blocks of `window` from its
    bit `start`, with `hist` the history before it (at most CTX bytes, all
    of them real: a dictionary, or the member's output so far).  `start`
    is a block boundary, or, given the `carry` the step before returned,
    a bit inside the block it hands on.

    Chains run from `start` and from `entries` (bit positions in the
    window; None: the scanner's entry in each `chunk_bytes` of it).  The
    step stops at the final block, once the chain holds `chain_cap` bytes
    of output at a block's end (a bound on the symbol words it holds on
    the device), or (final_input=False: more input can still come) where
    the window ends: inside a coded block at the end of its last whole
    symbol in the window, inside a stored block at the window's last
    byte, or at a block header that does not fit the window.  So a step
    reads the window and no more, however long its blocks.  With
    final_input=True a block that runs off the end raises its error.

    The chain is decoded here, its symbols left unresolved on the device.
    Returns (resolve, stop bit in the window, whether the final block was
    decoded, carry): `resolve` gives the step's output in stream order, a
    batch of at most `out_cap` bytes at a time (Resolve), and its `hist`
    is the history after the step once it is drained; carry is None at a
    block boundary, else the block that goes on at `stop` (its decode
    tables, or the rest of its stored payload) in the bits of the window
    that starts at byte stop >> 3 of this one, to pass to the next step."""
    dev = resolve_device(device)
    if entries is None:
        entries = scan.chunk_entries(window, chunk_bytes, device=dev)
    chain, stop, done, carry = _chain(
        window, entries, start, dev, hist_len=len(hist),
        final_input=final_input, out_cap=chain_cap, carry=carry)
    if carry is not None:
        carry = moved(carry, 8 * (stop >> 3))
    return Resolve(chain, window, hist, dev, out_cap), stop, done, carry


def _bit(key) -> int:
    """The bit where the row of a chain key starts."""
    return key[0] if isinstance(key, tuple) else key


def _chain(body: bytes, entries, start: int, dev: torch.device, *,
           hist_len: int, final_input: bool = True,
           out_cap: int | None = None, carry: BlockPlan | None = None):
    """Decode the chain of blocks from bit `start` of `body` in device
    rounds, beside the chains from `entries`.  Returns (chain, stop, done,
    carry): the decoded rows from `start` in stream order, the bit where
    the chain stopped (the final block's end bit when done), whether the
    final block is in it, and the block it stopped inside (None when it
    stopped at a block's header).  `carry` is such a block of the step
    before, at `start` (BlockPlan "cont" or "rest"): the chain from
    `start` goes on with it instead of parsing a header there.

    A coded block's first row escalates its span from SPAN0 to MAX_SPAN
    until its end-of-block lies in it.  A row that reaches MAX_SPAN bytes
    without it is proven up to the end of its last whole symbol, and the
    block goes on from there in a continuation row (plan_continuation) in
    the next round, so a block of any compressed length decodes in rows of
    at most MAX_SPAN bytes; the row that holds the end-of-block ends it.
    A carried coded block's first row starts at a span near the length the
    block already has (at most MAX_SPAN) and escalates like a first row.

    A block that runs off the end of `body` raises its error once the
    chain from `start` reaches it (EndOfStream, or stop_error's verdict on
    the symbol at the end).  With final_input=False it stops the chain
    instead: a coded row there is kept up to the end of its last whole
    symbol and the block is carried from there; a stored payload is kept
    up to the body's last byte and its rest carried; a header that does
    not fit stops the chain at the header.  out_cap stops the chain at the
    first block end where it holds that many output bytes.

    Errors come in stream order, as the serial decode meets them: when the
    chain from `start` reaches a block that failed, a match before it (in
    the rows before, or in the failed row's symbols before its stop) that
    reaches before the `hist_len` bytes of history raises InvalidMatch
    first; otherwise the block's own error is raised.  Only a failed
    chain pays for that test."""
    nbits = 8 * len(body)
    entries = {int(e) for e in entries if start < e < nbits}
    first = head = start if carry is None else carry.key()
    if carry is not None and carry.pos != start:
        raise ValueError(f"a carry at bit {carry.pos} for a step from bit "
                         f"{start}")
    frontier = {head, *entries}
    i2.STATS["chain_heads"] += len(frontier)
    decoded: dict = {}           # row key -> result/stored plan
    failed: dict = {}            # row key -> its FlateError
    partial: dict = {}           # failed row key -> its symbols before it
    # row keys the chain stops at for want of input -> the block carried
    # there (None: a header to parse again)
    waiting: dict = {}
    conts: dict = {}             # continuation row key -> its plan
    span: dict = {}
    serial_set: set = set()

    def off_the_end(key, err: FlateError) -> None:
        if final_input:
            failed[key] = err
        else:
            waiting[key] = None

    def fail(key, r: dict, err: FlateError) -> None:
        if isinstance(err, EndOfStream):
            off_the_end(key, err)
        else:
            failed[key] = err
        partial[key] = r

    def stored(key, p: BlockPlan) -> None:
        """A stored block's row, or the rest of its payload's; the part of
        a payload that runs past the body waits for more input."""
        have = len(body) - p.stored_off
        if p.stored_len <= have:
            end = 8 * (p.stored_off + p.stored_len)
            decoded[key] = {"plan": p, "end_bit": end, "next": end,
                            "out_len": p.stored_len, "stored": True,
                            "last": True}
            if not p.bfinal:
                frontier.add(end)
        elif final_input:
            failed[key] = EndOfStream("stored block past end")
        elif have <= 0:
            waiting[key] = p if p.kind == "rest" else None
        else:
            rest = plan_rest(p, nbits, p.stored_len - have)
            decoded[key] = {"plan": p, "end_bit": nbits, "next": rest.key(),
                            "out_len": have, "stored": True, "last": False}
            waiting[rest.key()] = rest

    if carry is not None and carry.kind == "rest":
        stored(head, carry)
    elif carry is not None:
        conts[head] = carry
        span[head] = min(_bucket((start - carry.block) >> 3, SPAN0),
                         MAX_SPAN)

    head_out, stall = 0, 0
    while True:
        todo = sorted(frontier - decoded.keys() - failed.keys()
                      - waiting.keys(), key=_bit)
        frontier.clear()
        plans = []
        for pos in todo:
            if pos in conts:
                plans.append(conts[pos])
                continue
            if pos >= nbits:
                off_the_end(pos, EndOfStream(
                    f"stream ends at bit {nbits} before its final block"))
                continue
            try:
                p = plan_block_at(body, pos, partial=True)
            except EndOfStream as e:
                off_the_end(pos, e)
                continue
            except FlateError as e:
                # a chain from a false entry runs into garbage: an error
                # counts only once the chain from `start` reaches it
                failed[pos] = e
                continue
            if p.kind == "stored":
                stored(pos, p)
            else:
                plans.append(p)
        if plans:
            i2.STATS["chained_rounds"] += 1
            res = _decode_round(body, plans, span, serial_set, dev)
            for key, r in res.items():
                p = r["plan"]
                span_end = 8 * min((p.pos >> 3) + r["span"], len(body))
                # (a row without its cut only escalates)
                bad = not r["has_eob"] and r["cut"] \
                    and _invalid_code_at_cut(r, span_end)
                if not r["has_eob"] and r["span"] < MAX_SPAN \
                        and span_end < nbits and not (r["ok"] and bad):
                    # EOB not in the row's span: escalate and retry
                    span[key] = r["span"] * 2
                    frontier.add(key)
                    continue
                if not r["ok"] and not r["serial"]:
                    # join failure: retry with the exact serial walk
                    serial_set.add(key)
                    frontier.add(key)
                    continue
                r["stored"], r["last"] = False, r["has_eob"]
                if r["has_eob"]:
                    r["next"] = r["end_bit"]
                    decoded[key] = r
                    if not p.bfinal:
                        frontier.add(r["end_bit"])
                elif bad:
                    fail(key, r, InvalidCode(
                        f"{_where(p)} undecodable at bit {r['end_bit']}"))
                elif span_end == nbits and final_input:
                    # stopped within a symbol of the body's end: that
                    # symbol's own verdict
                    fail(key, r, stop_error(body, p, r["end_bit"]))
                elif span_end == nbits and r["counts"] == 0:
                    # not one whole symbol left in the window: wait here
                    waiting[key] = p if p.kind == "cont" else None
                elif r["counts"] == 0:
                    # no progress: never a loop
                    fail(key, r, InvalidCode(
                        f"{_where(p)} undecodable at bit {r['end_bit']}"))
                else:
                    # proven up to its cut: the block goes on from there,
                    # in the next round or (at the window's end) the next
                    # step
                    q = plan_continuation(p, r["end_bit"])
                    r["next"] = q.key()
                    decoded[key] = r
                    if span_end == nbits:
                        waiting[q.key()] = q
                    else:
                        conts[q.key()] = q
                        frontier.add(q.key())
                    i2.STATS["continuation_rows"] += 1
        # walk the chain from its head through what is decoded.  The head's
        # row is always in the frontier, so every round either finishes
        # it or retries it (span escalation / serial rewalk, both bounded)
        # — a persistent stall is a logic error, not data.  Progress is a
        # row, so a block of many continuation rows moves the head in
        # every round.
        pos, done, capped = head, False, False
        while pos in decoded:
            r = decoded[pos]
            if r["last"] and r["plan"].bfinal:
                done = True
                break
            head_out += r["out_len"]
            pos = r["next"]
            if r["last"] and out_cap is not None and head_out >= out_cap:
                capped = True
                break
        if done or capped or pos in waiting:
            break
        if pos in failed:
            rows = []
            at = first
            while at != pos:
                rows.append(decoded[at])
                at = decoded[at]["next"]
            if pos in partial:
                rows.append(partial[pos])
            if _reaches_before(rows, hist_len):
                raise InvalidMatch("a match reaches before the start of "
                                   "the history")
            raise failed[pos]
        stall = stall + 1 if pos == head else 0
        head = pos
        frontier.add(pos)
        if stall > 12:
            raise InvalidCode("block chain did not converge")

    chain = []
    at = first
    while at in decoded and (done or at != pos):
        r = decoded[at]
        chain.append(r)
        at = r["next"]
        if r["last"] and r["plan"].bfinal:
            break
    carried = None if done or capped else waiting.get(at)
    on_chain = {r["plan"].pos for r in chain
                if r["plan"].kind in ("stored", "coded")}
    stop = _bit(at)
    i2.STATS["false_heads"] += sum(1 for e in entries
                                   if e < stop and e not in on_chain)
    return chain, stop, done, carried


class Resolve:
    """The LZ resolution of a decoded chain's rows in stream order, an
    iterator of bytes-like parts: a batch of at most RES_B rows resolved
    at a time, with the last CTX bytes of output as the next batch's
    context.  `hist` is the history before the chain, every byte of it
    real: a match that reaches before it raises InvalidMatch when its
    batch is resolved, after the parts before it.  A row that does not
    end its block gets an end-of-block word of its own, as _pieces gives
    one.  A stored row is a slice of `body`.

    With `out_cap` (more than a match's 258 bytes) no part holds more
    than out_cap bytes: rows are cut into pieces of at most
    min(MAX_S, out_cap) bytes, a batch ends before the piece that would
    take it past out_cap, and a stored row is given in slices of at most
    out_cap.  Without it a batch is RES_B pieces of at most MAX_S bytes.
    A batch is resolved only when the part before it has been taken, so
    the output held is one part.  `hist` is the history after the parts
    taken so far: once drained, the history after the chain."""

    def __init__(self, chain: list, body: bytes, hist: bytes,
                 dev: torch.device, out_cap: int | None = None):
        if out_cap is not None and out_cap <= consts.MAX_MATCH_LEN:
            raise ValueError(f"out_cap {out_cap} does not hold a match")
        self.hist = hist
        self._dev = dev
        self._parts = self._run(chain, body, out_cap)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._parts)

    def _flush(self, rows: list) -> memoryview:
        dev = self._dev
        S = _bucket(max(max(ol for _, _, ol in rows), 1024), 1024)
        NSr = max(c for _, c, _ in rows)
        w = torch.stack([torch.nn.functional.pad(wr, (0, NSr - c))
                         for wr, c, _ in rows])
        counts = torch.tensor([c for _, c, _ in rows],
                              dtype=torch.int32, device=dev)
        out_lens = torch.tensor([ol for _, _, ol in rows],
                                dtype=torch.int32, device=dev)
        ctx0 = np.zeros(CTX, np.uint8)
        if self.hist:
            ctx0[CTX - len(self.hist):] = np.frombuffer(self.hist, np.uint8)
        flat, err = resolve_compact(w, counts, out_lens,
                                    torch.from_numpy(ctx0).to(dev), S=S,
                                    hist_len=len(self.hist))
        if bool(err.any()):
            raise InvalidMatch("a match reaches before the start of the "
                               "history")
        total = sum(ol for _, _, ol in rows)
        r = flat[:total].cpu().numpy()
        self.hist = (self.hist + r[-CTX:].tobytes())[-CTX:]
        rows.clear()
        return memoryview(r)

    def _run(self, chain: list, body: bytes, out_cap: int | None):
        cap = MAX_S if out_cap is None else min(MAX_S, out_cap)
        rows: list = []
        for r in chain:
            if r["stored"]:
                if rows:
                    yield self._flush(rows)
                p = r["plan"]
                s = body[p.stored_off:p.stored_off + r["out_len"]]
                step = out_cap or max(len(s), 1)
                for a in range(0, len(s), step):
                    part = s[a:a + step]
                    self.hist = (self.hist + part[-CTX:])[-CTX:]
                    yield part
                continue
            w = r["words"][r["row"], :r["counts"]]
            if not r["last"]:
                w = torch.nn.functional.pad(w, (0, 1), value=_EOB_WORD)
            for piece in _pieces(w, r["out_len"], cap):
                if len(rows) == RES_B or out_cap is not None and rows and \
                        sum(ol for _, _, ol in rows) + piece[2] > out_cap:
                    yield self._flush(rows)
                rows.append(piece)
        if rows:
            yield self._flush(rows)
