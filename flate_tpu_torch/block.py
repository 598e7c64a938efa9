"""Deflate block encoding on the host: token histograms, the dynamic
header's code-length RLE, the exact bit-cost model, and the choice among
stored, fixed, dynamic and literal-only blocks.

The port's copy of flate_tpu/block.py (:30-328), which the round-1
encoder's planner and splice (device/pipeline.py) and its host tail
encoder (deflate.py) write with.  Tokens are a structure of arrays:
``length`` (0 => literal) + ``lit`` byte + ``dist``.  The cheapest
representation always wins (no hysteresis).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import consts, huffman, tables
from .bitpack import BitSink

MAX_STORED = consts.MAX_STORED_BLOCK


@dataclass
class Tokens:
    """lit: uint8 literal values; length: int32 (0 => literal, else 3..258);
    dist: int32 (1..32768 for matches)."""
    lit: np.ndarray
    length: np.ndarray
    dist: np.ndarray

    @property
    def n(self) -> int:
        return self.lit.size

    @staticmethod
    def literals(data: np.ndarray) -> "Tokens":
        data = np.asarray(data, dtype=np.uint8)
        z = np.zeros(data.size, dtype=np.int32)
        return Tokens(lit=data, length=z, dist=z.copy())


def token_histograms(toks: Tokens) -> tuple[np.ndarray, np.ndarray]:
    """(litlen freq[286] incl. EOB, dist freq[30])."""
    is_match = toks.length >= consts.MIN_MATCH_LEN
    litlen_sym = np.where(
        is_match,
        257 + tables.LENGTH_TO_CODE[np.maximum(toks.length, 3) - 3],
        toks.lit.astype(np.int32),
    )
    freq_litlen = np.bincount(litlen_sym, minlength=consts.NUM_LITLEN)[
        :consts.NUM_LITLEN].astype(np.int64)
    freq_litlen[consts.END_OF_BLOCK] += 1
    dsym = tables.DIST_TO_CODE[np.maximum(toks.dist, 1) - 1]
    freq_dist = np.bincount(dsym, weights=is_match, minlength=consts.NUM_DIST)[
        :consts.NUM_DIST].astype(np.int64)
    return freq_litlen, freq_dist


# ---------------------------------------------------------------------------
# Codegen (RFC 1951 §3.2.7 RLE of code lengths)
# ---------------------------------------------------------------------------

def generate_codegen(litlen_lens: np.ndarray, dist_lens: np.ndarray
                     ) -> tuple[list[tuple[int, int, int]], int, int]:
    """RLE-encode the concatenated code lengths.

    Returns (items, hlit, hdist) where items is a list of
    (codegen_symbol, extra_value, extra_bits).

    The RLE is run separately over the litlen and dist sections so no
    repeat code (16/17/18) spans the hlit boundary: strict decoders
    decode the two sections independently and reject headers whose runs
    cross it.
    """
    hlit = max(257, int(np.max(np.nonzero(litlen_lens)[0], initial=256)) + 1)
    hdist = max(1, int(np.max(np.nonzero(dist_lens)[0], initial=0)) + 1)
    items: list[tuple[int, int, int]] = []
    for seq in (litlen_lens[:hlit].astype(int), dist_lens[:hdist].astype(int)):
        _codegen_rle(seq, items)
    return items, hlit, hdist


def _codegen_rle(seq: np.ndarray, items: list[tuple[int, int, int]]) -> None:
    i = 0
    n = seq.size
    while i < n:
        v = int(seq[i])
        j = i + 1
        while j < n and seq[j] == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                items.append((18, r - 11, 7))
                run -= r
            if run >= 3:
                items.append((17, run - 3, 3))
                run = 0
            items.extend([(0, 0, 0)] * run)
        else:
            items.append((v, 0, 0))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                items.append((16, r - 3, 2))
                run -= r
            items.extend([(v, 0, 0)] * run)
        i = j


def _codegen_freq(items) -> np.ndarray:
    f = np.zeros(consts.NUM_CODEGEN, dtype=np.int64)
    for sym, _, _ in items:
        f[sym] += 1
    return f


def _hclen(codegen_lens: np.ndarray) -> int:
    order = tables.CODEGEN_ORDER
    last = 3  # minimum 4 entries
    for i in range(consts.NUM_CODEGEN - 1, -1, -1):
        if codegen_lens[order[i]] != 0:
            last = i
            break
    return max(4, last + 1)


# ---------------------------------------------------------------------------
# Exact bit-cost model
# ---------------------------------------------------------------------------

def _extra_bits_cost(freq_litlen: np.ndarray, freq_dist: np.ndarray) -> int:
    lb = (freq_litlen[257:257 + 29] * tables.LENGTH_EXTRA_BITS).sum()
    db = (freq_dist * tables.DIST_EXTRA_BITS).sum()
    return int(lb + db)


def fixed_size(freq_litlen: np.ndarray, freq_dist: np.ndarray) -> int:
    body = huffman.bit_length(freq_litlen, tables.FIXED_LITLEN_LENS[:consts.NUM_LITLEN])
    body += huffman.bit_length(freq_dist, tables.FIXED_DIST_LENS[:consts.NUM_DIST])
    return 3 + body + _extra_bits_cost(freq_litlen, freq_dist)


def dynamic_size(freq_litlen, freq_dist, litlen_lens, dist_lens,
                 codegen_items, codegen_lens, hlit, hdist) -> int:
    hclen = _hclen(codegen_lens)
    header = 3 + 5 + 5 + 4 + 3 * hclen
    for sym, _, eb in codegen_items:
        header += int(codegen_lens[sym]) + eb
    body = huffman.bit_length(freq_litlen, litlen_lens)
    body += huffman.bit_length(freq_dist, dist_lens)
    return header + body + _extra_bits_cost(freq_litlen, freq_dist)


def stored_size(n: int, bit_pos: int) -> int:
    """Exact cost in bits of storing n raw bytes starting at bit_pos
    (mod 8), including headers, LEN/NLEN and alignment padding."""
    nblocks = max(1, -(-n // MAX_STORED))
    bits = 0
    pos = bit_pos % 8
    for b in range(nblocks):
        pos = (pos + 3) % 8
        pad = (8 - pos) % 8
        blen = min(n - b * MAX_STORED, MAX_STORED)
        bits += 3 + pad + 32 + blen * 8
        pos = 0
    return bits


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

def _emit_stored(sink: BitSink, raw: bytes, final: bool) -> None:
    n = len(raw)
    nblocks = max(1, -(-n // MAX_STORED))
    for b in range(nblocks):
        chunk = raw[b * MAX_STORED:(b + 1) * MAX_STORED]
        is_final = final and b == nblocks - 1
        sink.append_fields(np.array([int(is_final)], dtype=np.uint64),
                           np.array([3]))
        sink.align_to_byte()
        ln = len(chunk)
        sink.append_bytes(bytes([ln & 0xFF, ln >> 8,
                                 (~ln) & 0xFF, ((~ln) >> 8) & 0xFF]))
        sink.append_bytes(bytes(chunk))


def _token_fields(toks: Tokens, ll_codes, ll_lens, d_codes, d_lens
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-token (value, nbits) field matrix flattened in emission order."""
    n = toks.n
    is_match = toks.length >= consts.MIN_MATCH_LEN
    lcode_idx = tables.LENGTH_TO_CODE[np.maximum(toks.length, 3) - 3]
    litlen_sym = np.where(is_match, 257 + lcode_idx, toks.lit.astype(np.int32))
    dsym = tables.DIST_TO_CODE[np.maximum(toks.dist, 1) - 1]

    vals = np.zeros((n, 4), dtype=np.uint64)
    bits = np.zeros((n, 4), dtype=np.int64)
    vals[:, 0] = ll_codes[litlen_sym]
    bits[:, 0] = ll_lens[litlen_sym]
    # length extra bits
    le = tables.LENGTH_EXTRA_BITS[lcode_idx]
    lv = (toks.length - tables.LENGTH_BASE[lcode_idx]).astype(np.uint64)
    vals[:, 1] = np.where(is_match, lv, 0)
    bits[:, 1] = np.where(is_match, le, 0)
    # distance code
    vals[:, 2] = np.where(is_match, d_codes[dsym], 0)
    bits[:, 2] = np.where(is_match, d_lens[dsym], 0)
    de = tables.DIST_EXTRA_BITS[dsym]
    dv = (toks.dist - tables.DIST_BASE[dsym]).astype(np.uint64)
    vals[:, 3] = np.where(is_match, dv, 0)
    bits[:, 3] = np.where(is_match, de, 0)
    return vals.ravel(), bits.ravel()


def _emit_coded(sink: BitSink, toks: Tokens, final: bool,
                header_vals: list[int], header_bits: list[int],
                ll_codes, ll_lens, d_codes, d_lens) -> None:
    hv, hb = _token_fields(toks, ll_codes, ll_lens, d_codes, d_lens)
    vals = np.concatenate([
        np.asarray(header_vals, dtype=np.uint64), hv,
        np.asarray([ll_codes[consts.END_OF_BLOCK]], dtype=np.uint64)])
    bits = np.concatenate([
        np.asarray(header_bits, dtype=np.int64), hb,
        np.asarray([ll_lens[consts.END_OF_BLOCK]], dtype=np.int64)])
    sink.append_fields(vals, bits)


def _coded_plans(toks: Tokens):
    """Cost the fixed and dynamic representations of a token block.

    Returns (fixed_bits, dynamic_bits, emit) where emit(sink, final, kind)
    writes the chosen representation."""
    freq_ll, freq_d = token_histograms(toks)

    ll_lens = huffman.huffman_code_lengths(freq_ll, consts.MAX_CODE_BITS)
    d_lens = huffman.huffman_code_lengths(freq_d, consts.MAX_CODE_BITS)
    if not d_lens.any():
        # at least one distance code must be present
        d_lens[0] = 1
    ll_codes = tables.canonical_codes(ll_lens)
    d_codes = tables.canonical_codes(d_lens)

    cg_items, hlit, hdist = generate_codegen(ll_lens, d_lens)
    cg_freq = _codegen_freq(cg_items)
    cg_lens = huffman.huffman_code_lengths(cg_freq, consts.MAX_CODEGEN_BITS)
    cg_codes = tables.canonical_codes(cg_lens)

    dyn = dynamic_size(freq_ll, freq_d, ll_lens, d_lens, cg_items, cg_lens,
                       hlit, hdist)
    fix = fixed_size(freq_ll, freq_d)

    def emit(sink: BitSink, final: bool, kind: str) -> None:
        if kind == "fixed":
            _emit_coded(sink, toks, final, [int(final) | (1 << 1)], [3],
                        tables.FIXED_LITLEN_CODES, tables.FIXED_LITLEN_LENS,
                        tables.FIXED_DIST_CODES, tables.FIXED_DIST_LENS)
            return
        hclen = _hclen(cg_lens)
        hv = [int(final) | (2 << 1), hlit - 257, hdist - 1, hclen - 4]
        hb = [3, 5, 5, 4]
        for i in range(hclen):
            hv.append(int(cg_lens[tables.CODEGEN_ORDER[i]]))
            hb.append(3)
        for sym, ev, eb in cg_items:
            hv.append(int(cg_codes[sym]))
            hb.append(int(cg_lens[sym]))
            if eb:
                hv.append(ev)
                hb.append(eb)
        _emit_coded(sink, toks, final, hv, hb, ll_codes, ll_lens,
                    d_codes, d_lens)

    return fix, dyn, emit


def write_block(sink: BitSink, toks: Tokens, final: bool,
                raw: bytes | None = None) -> None:
    """Encode one token block choosing the cheapest representation among
    {fixed, dynamic, stored, literal-only fixed/dynamic}.

    raw: the exact input bytes the tokens were produced from (enables the
    stored and literal-only fallbacks).  The literal-only alternative
    covers inputs where LZ matches cost more than they save (e.g. digit
    streams)."""
    fix, dyn, emit = _coded_plans(toks)
    options = [(dyn, lambda: emit(sink, final, "dynamic")),
               (fix, lambda: emit(sink, final, "fixed"))]
    if raw is not None:
        sto = stored_size(len(raw), sink.bit_length)
        options.append((sto, lambda: _emit_stored(sink, raw, final)))
        has_matches = bool((toks.length >= consts.MIN_MATCH_LEN).any())
        if has_matches:
            lt = Tokens.literals(np.frombuffer(raw, dtype=np.uint8))
            lfix, ldyn, lemit = _coded_plans(lt)
            options.append((ldyn, lambda: lemit(sink, final, "dynamic")))
            options.append((lfix, lambda: lemit(sink, final, "fixed")))
    options.sort(key=lambda t: t[0])
    options[0][1]()


def write_stored(sink: BitSink, raw: bytes, final: bool) -> None:
    _emit_stored(sink, raw, final)


def write_huffman_only(sink: BitSink, raw: bytes, final: bool) -> None:
    """Literal-only dynamic block from the byte histogram
    with the stored fallback when cheaper."""
    toks = Tokens.literals(np.frombuffer(raw, dtype=np.uint8))
    write_block(sink, toks, final, raw=raw)


def write_flush_marker(sink: BitSink) -> None:
    """Empty stored block + byte alignment = the flush()/Z_SYNC_FLUSH marker
    (Z_SYNC_FLUSH): bits 000, pad, then 00 00 FF FF."""
    sink.append_fields(np.array([0], dtype=np.uint64), np.array([3]))
    sink.align_to_byte()
    sink.append_bytes(b"\x00\x00\xff\xff")
