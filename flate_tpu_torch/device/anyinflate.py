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
2. **Chained block decode** (device): each round decodes one block per
   active chain position — pass1 speculative symbol decode over the
   block's span, multi-lane walk with join resolve (device/inflate2.py),
   symbol compaction with EOB discovery.  The EOB gives the exact bit
   position of the NEXT block header, which the host parses (tiny) and
   queues for the next round, so all chains advance concurrently.
3. **LZ resolution in stream order** (device): the chain's blocks are
   batched consecutively and resolved with a COMPACT output layout (rows
   at cumulative offsets, so cross-block back-references inside a batch
   land on real bytes) and a 32 KiB context carry between batches.
   Stored blocks are raw byte spans flushed from the host.

Correctness never depends on speculation: join failures re-decode the
block with the exact serial walk; spans too short to contain the EOB
escalate; what still fails raises.  A block that runs off the end of the
body (no EOB up to the last bit, and no invalid code wholly before it), an
EOB past the last bit, or a chain that reaches the end of the body before
its final block raises EndOfStream, as the JAX package's public decode
does for a truncated stream; other failures raise InvalidCode.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import consts, tables
from .. import inflate as hinf
from ..containers import Container, Hasher, parse_footer, parse_header
from ..errors import (
    EndOfStream,
    FlateError,
    InvalidBlockType,
    InvalidCode,
    WrongStoredBlockNlen,
)
from . import inflate2 as i2
from . import resolve_device, scan

CTX = consts.MAX_DISTANCE

CHUNK_BYTES = 1 << 19            # chain spacing of the chunk-entry scanner
SPAN0 = 1 << 16                  # initial block span (64 KiB comp)
MAX_SPAN = 1 << 21               # escalation cap (2 MiB comp)
RES_B = 8                        # resolve batch rows
MAX_S = 1 << 22                  # output bytes of a resolve row
# bit positions one symbol_batch call may hold: pass 1 makes a few dozen
# int32 temporaries of this many elements, so a round's rows go through
# in chunks
MAX_POSITIONS = 1 << 25
# the longest symbol: a 15-bit length code, 5 extra bits, a 15-bit
# distance code and 13 extra bits
MAX_SYMBOL_BITS = 48


# ---------------------------------------------------------------------------
# Host-side block planning at an exact bit position
# ---------------------------------------------------------------------------

class BlockPlan:
    __slots__ = ("kind", "pos", "bfinal", "body_bit", "ll", "d",
                 "stored_off", "stored_len", "end_bit")


def plan_block_at(body: bytes, pos: int) -> BlockPlan:
    """Parse ONE block header at exact bit `pos` (host, tiny).

    stored blocks are fully resolved here (end_bit known); coded blocks
    get canonical decode scalars and decode on device."""
    p = BlockPlan()
    p.pos = pos
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
        if p.stored_off + ln > len(body):
            raise EndOfStream("stored block past end")
        p.end_bit = (p.stored_off + ln) * 8
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
    p.kind = "coded"
    p.body_bit = bits.pos
    p.ll = i2.canonical_scalars(ll_lens, 288)
    p.d = i2.canonical_scalars(d_lens, 32)
    return p


# ---------------------------------------------------------------------------
# Device stages
# ---------------------------------------------------------------------------

def symbol_batch(comp, clen, start, lims_ll, kbase_ll, syms_ll,
                 lims_d, kbase_d, syms_d, *, NS: int,
                 G: int = i2.LANE_G, serial: bool = False):
    """Span bytes -> compacted true symbols (stay on device).

    Returns (words (B, NS), counts, spec_fail, has_eob, out_len,
    end_bit).  serial=True uses the exact one-symbol-per-step walk
    (retry path for join failures)."""
    word = i2._pass1(comp, lims_ll, kbase_ll, syms_ll,
                     lims_d, kbase_d, syms_d)
    if serial:
        # the serial walk already emits compacted words + counts; the
        # extras of _extract are recomputed from them
        words, counts = i2._walk(word, start, 8 * clen, NS)
        slots = torch.arange(NS, dtype=torch.int32,
                             device=words.device)[None, :]
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
        return words, counts, ~has_eob, has_eob, out_len, end_bit
    mask, joined = i2._lane_walk(word, start, 8 * clen, G=G)
    return i2._extract(word, mask, joined, start, NS, G)


def resolve_compact(words, counts, out_lens, ctx0, *, S: int):
    """Parallel LZ resolution with COMPACT row placement.

    words (B, NS) compacted symbols of CONSECUTIVE blocks; row b's
    output occupies [CTX + prefix(out_lens)[b], ... + out_lens[b]) of a
    flat buffer, so back-references cross rows exactly like the
    original stream (variable-size blocks — unlike inflate2._resolve
    whose rows sit at a fixed stride).  Returns (flat (B*S,) u8 whose
    first sum(out_lens) bytes are the stream, err (B,))."""
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
    err = err + (is_m & (base + offs - dist < 0)).sum(dim=1)
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


def _pieces(words: torch.Tensor, out_len: int) -> list:
    """One block's symbols (words (counts,), the end-of-block last) as
    resolve rows (words, counts, out_len) of at most MAX_S output bytes
    each, cut at symbol boundaries: the symbols that start in each
    MAX_S - 257 bytes of the block's output, so a row holds at most
    MAX_S - 258 + 258 bytes.  A row that does not end at the block's end
    gets an end-of-block word of its own (symbol_fields wants one at
    counts - 1).  A match of a later row reaches back into the earlier
    rows of its batch or into the context carried from the batch
    before, like a match across blocks."""
    n = words.shape[0]
    if out_len <= MAX_S:
        return [(words, n, out_len)]
    kind = (words >> 6) & 3
    olen = torch.where(kind == i2.K_MATCH, ((words >> 8) & 0xFF) + 3,
                       (kind == i2.K_LIT).to(torch.int32))
    starts = torch.cumsum(olen, dim=0) - olen
    targets = torch.arange(MAX_S - 257, out_len, MAX_S - 257,
                           dtype=starts.dtype, device=words.device)
    cuts = torch.searchsorted(starts, targets)
    cut_np, at_np = torch.stack([cuts, starts[cuts]]).cpu().numpy()
    eob = torch.full((1,), i2.K_EOB << 6, dtype=words.dtype,
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
    """One fetched tensor for the five per-row results of a group;
    end_bit is span-relative (<= 2 MiB * 8 bits), so int32 is safe."""
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
    """Decode one block per plan on device; returns pos -> result dict
    with (words ref, row, counts, out_len, end_bit, ok).  A row of a C-byte
    span has 8 C symbol slots: a symbol takes at least one bit, so the
    chain always fits, however short its symbols."""
    groups: dict = {}
    for p in plans:
        byte0 = p.pos >> 3
        cap = span.get(p.pos, SPAN0)
        C = _bucket(min(len(body) - byte0, cap), 8192)
        key = (C, p.pos in serial_set)
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
            words, counts, fail, has_eob, out_len, end_bit = symbol_batch(
                *i2.args_from_numpy((comp, clen, start, sc_ll, kb_ll, sy_ll,
                                     sc_d, kb_d, sy_d), dev),
                NS=8 * C, serial=serial)
            meta_np = _pack_meta(counts, fail, has_eob, out_len,
                                 end_bit).cpu().numpy()
            cn_np, fail_np, eob_np, ol_np, eb_np = meta_np
            for bi, (p, byte0) in enumerate(part):
                results[p.pos] = {
                    "words": words, "row": bi, "plan": p,
                    "counts": int(cn_np[bi]),
                    "out_len": int(ol_np[bi]),
                    "end_bit": 8 * byte0 + int(eb_np[bi]),
                    "has_eob": bool(eob_np[bi]),
                    "ok": not bool(fail_np[bi]),
                    "serial": serial,
                    "span": C,
                }
    return results


def _runs_off_the_end(r: dict, nbits: int) -> bool:
    """Whether a coded block whose serial walk found no EOB ran off the
    end of the body's `nbits` bits: its span reaches the end and no
    invalid code (K_BAD) of the walk lies wholly before it."""
    if (r["plan"].pos >> 3) + r["span"] < nbits >> 3:
        return False
    w = r["words"][r["row"], :r["counts"]].cpu().numpy()
    bad = np.flatnonzero(((w >> 6) & 3) == i2.K_BAD)
    if bad.size == 0:
        return True
    at = r["plan"].body_bit + int((w[:bad[0]] & 63).sum())
    return at + MAX_SYMBOL_BITS > nbits


def decompress_device_any(data: bytes,
                          container: Container = Container.GZIP,
                          verify: bool = True, *,
                          chunk_bytes: int = CHUNK_BYTES,
                          device: str | torch.device = "cuda") -> bytes:
    """Device decode of an arbitrary (unindexed) single/multi-member
    stream, each member as chains from bit 0 and from the chunk entries
    the scanner finds every `chunk_bytes` of its body."""
    dev = resolve_device(device)
    out = bytearray()
    offset = 0
    while offset < len(data):
        chunk, offset = _decompress_member_any(
            data, offset, container, verify, dev, chunk_bytes=chunk_bytes)
        out += chunk
        if container is not Container.GZIP:
            break
    return bytes(out)


def _decompress_member_any(data: bytes, offset: int,
                           container: Container, verify: bool,
                           dev: torch.device, *,
                           chunk_bytes: int = CHUNK_BYTES,
                           entries: list | None = None):
    """`entries` gives KNOWN block-header bit positions (relative to the
    member body) as chain heads — e.g. the per-shard offsets of an FLT1
    index, which make every chain exact.  None scans the body for one
    entry per chunk of `chunk_bytes` (scan.chunk_entries)."""
    i2.STATS["chained_members"] += 1
    hdr_len, _meta = parse_header(container, data[offset:])
    body = data[offset + hdr_len:]
    nbits = 8 * len(body)

    # ---- chain heads --------------------------------------------------
    if entries is None:
        entries = scan.chunk_entries(body, chunk_bytes, device=dev)
    else:
        entries = sorted({0, *(int(e) for e in entries if e < nbits)})
    i2.STATS["chain_heads"] += len(entries)

    # ---- chained decode rounds ----------------------------------------
    decoded: dict = {}           # header bit pos -> result/stored plan
    failed: dict = {}            # header bit pos -> its FlateError
    frontier = set(entries)
    span: dict = {}
    serial_set: set = set()
    final_pos = None             # header pos of the BFINAL block
    chain_head = 0
    stall = 0
    while True:
        todo = sorted(frontier - set(decoded) - set(failed))
        if not todo:
            break
        plans = []
        for pos in todo:
            frontier.discard(pos)
            if pos >= nbits:
                failed[pos] = EndOfStream(
                    f"stream ends at bit {nbits} before its final block")
                continue
            try:
                p = plan_block_at(body, pos)
            except FlateError as e:
                # a chain from a false entry runs into garbage: an error
                # counts only once chain 0 reaches its position
                failed[pos] = e
                continue
            if p.kind == "stored":
                decoded[pos] = {"plan": p, "end_bit": p.end_bit,
                                "ok": True, "stored": True}
                if not p.bfinal:
                    frontier.add(p.end_bit)
                elif final_pos is None:
                    final_pos = pos
            else:
                plans.append(p)
        if plans:
            i2.STATS["chained_rounds"] += 1
            res = _decode_round(body, plans, span, serial_set, dev)
            for pos, r in res.items():
                if not r["has_eob"] and r["span"] < MAX_SPAN \
                        and (pos >> 3) + r["span"] < len(body):
                    # EOB not in span: escalate the span and retry
                    span[pos] = r["span"] * 2
                    frontier.add(pos)
                    continue
                if not r["ok"] and not r["serial"]:
                    # join failure: retry with the exact serial walk
                    serial_set.add(pos)
                    frontier.add(pos)
                    continue
                if not r["ok"]:
                    if _runs_off_the_end(r, nbits):
                        failed[pos] = EndOfStream(
                            f"block at bit {pos} runs past the end of "
                            f"the stream")
                    else:
                        failed[pos] = InvalidCode(
                            f"block at bit {pos} undecodable")
                    continue
                if r["end_bit"] > nbits:
                    failed[pos] = EndOfStream(
                        f"block at bit {pos} ends past the end of the "
                        f"stream")
                    continue
                r["stored"] = False
                decoded[pos] = r
                if not r["plan"].bfinal:
                    frontier.add(r["end_bit"])
                elif final_pos is None:
                    final_pos = pos
        # chain-complete check: walk from 0 through decoded.  The chain
        # head's block is always in the frontier, so every round either
        # finishes it or retries it (span escalation / serial rewalk,
        # both bounded) — a persistent stall is a logic error, not data.
        pos = chain_head
        while pos in decoded and not decoded[pos]["plan"].bfinal:
            pos = decoded[pos]["end_bit"]
        if pos in decoded and decoded[pos]["plan"].bfinal:
            break
        if pos in failed:
            raise failed[pos]
        stall = stall + 1 if pos == chain_head else 0
        chain_head = pos
        frontier.add(pos)
        if stall > 12:
            raise InvalidCode("block chain did not converge")

    # ---- confirmed chain in stream order ------------------------------
    chain = []
    pos = 0
    while True:
        if pos not in decoded:
            raise InvalidCode(f"chain break at bit {pos}")
        r = decoded[pos]
        chain.append(r)
        if r["plan"].bfinal:
            end_bit = r["end_bit"]
            break
        pos = r["end_bit"]

    # ---- resolve in stream order with context carry -------------------
    out = bytearray()
    hasher = Hasher(container)

    def flush(rows):
        """Resolve rows (words, counts, out_len) of consecutive output."""
        S = _bucket(max(max(ol for _, _, ol in rows), 1024), 1024)
        NSr = max(c for _, c, _ in rows)
        w = torch.stack([torch.nn.functional.pad(wr, (0, NSr - c))
                         for wr, c, _ in rows])
        counts = torch.tensor([c for _, c, _ in rows],
                              dtype=torch.int32, device=dev)
        out_lens = torch.tensor([ol for _, _, ol in rows],
                                dtype=torch.int32, device=dev)
        ctx0 = np.zeros(CTX, np.uint8)
        hist = bytes(out[-CTX:])
        if hist:
            ctx0[CTX - len(hist):] = np.frombuffer(hist, np.uint8)
        flat, err = resolve_compact(w, counts, out_lens,
                                    torch.from_numpy(ctx0).to(dev), S=S)
        if bool(err.any()):
            raise InvalidCode("device resolve failed")
        total = sum(ol for _, _, ol in rows)
        r = flat[:total].cpu().numpy().tobytes()
        out.extend(r)
        hasher.update(r)

    batch: list = []
    for r in chain:
        if r.get("stored"):
            if batch:
                flush(batch)
                batch = []
            p = r["plan"]
            s = body[p.stored_off:p.stored_off + p.stored_len]
            out.extend(s)
            hasher.update(s)
            continue
        for piece in _pieces(r["words"][r["row"], :r["counts"]],
                             r["out_len"]):
            batch.append(piece)
            if len(batch) >= RES_B:
                flush(batch)
                batch = []
    if batch:
        flush(batch)

    foot_off = offset + hdr_len + ((end_bit + 7) // 8)
    if verify:
        foot_len = parse_footer(container, data[foot_off:], hasher)
    else:
        foot_len = container.footer_size
    return bytes(out), foot_off + foot_len
