"""Chunk-entry scanner: validated dynamic-block headers at any bit offset.

Counterpart of the JAX package's host C scanner (flate_tpu/native/
fastinflate.c:995-1101, `scan_headers` with `validate_dyn_header`, called
through flate_tpu/native/__init__.py:432) and of the chunk-entry list its
member loop builds (flate_tpu/jx/anyinflate.py:365-373).  A stream that
another encoder wrote carries no index, so the chained decode
(device/anyinflate.py) needs one confirmed block header in each chunk of
the member body to start a chain there; every dynamic-block header is such
a point.

Every bit offset p in [start_bit, end_bit) is tested with a cheap-filter
cascade -- BTYPE == 2, HLIT <= 29, HDIST <= 29, and a code-length code
whose Kraft sum over its HCLEN 3-bit fields is exactly 128 -- and the few
offsets that pass get the full header parse: the code-length code, the
literal/length and distance lengths as two separate run-length-coded
reads, and the completeness rules of both codes.  The C's semantics are
kept, not RFC 1951's, so the port finds exactly the C's offsets:

- a repeat-16 at the first distance length is an error (the RFC lets a
  repeat cross from the literal/length lengths into the distance lengths);
- symbol 256 must have a code;
- an incomplete literal/length or distance code passes only as one code of
  length 1; the code-length code must be complete; all-zero distance
  lengths pass;
- a read past the end of the data fails;
- no offset at or above nbits - 96 is tested;
- the offset reported is the BFINAL bit, whose value is not checked.

On CUDA data a launch of `scan_kernel` (csrc/decode_kernels.cu,
`flate_scan_headers`) finds the first header of each of its segments and
stops at what that list needs: a persistent grid takes tiles of SCAN_TILE
offsets in offset order, every segment from its start at once, and a
segment keeps its first header and skips its tiles past it.  The kernel
writes the list itself into a small int64 state that is fetched once.
chunk_entries is one launch, a segment a chunk; scan_headers is one launch
a header, over one segment from past the header before.  On CPU data the
plain version
runs: the cheap filter vectorised over offsets, then the full parse of the
survivors in offset order with the port's host header parser (inflate.py,
the C's rules), stopping once `max_out` are found.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build, consts
from .. import inflate as hinf
from ..errors import FlateError
from . import resolve_device

# The C tests no offset at or above nbits - 96: a minimal header must fit.
TAIL_BITS = 96
# Offsets a call of the plain cheap filter holds at once: the first window
# of a scan, doubled window by window up to the last (its temporaries are
# a few int64 tensors of this many elements).  A scan that stops at its
# first header filters little past it.
FILTER_WINDOW0 = 1 << 16
FILTER_WINDOW = 1 << 22
# Kraft weight 2^(7 - len) of a code-length code length (0: no code).
KRAFT = (0, 64, 32, 16, 8, 4, 2, 1)
# Offsets a tile of scan_kernel (csrc kScanTile).
SCAN_TILE = 2048
# The kernel's state, int64, zero-filled: the segments handed out past the
# grid's first, the segments with a header, the offsets and tiles tested;
# then ~ each segment's first header (0: none, so ~ gives -1), then each
# segment's next tile.
STATE_NEXT, STATE_FOUND, STATE_TESTED, STATE_TILES = range(4)
STATE_HEAD = 4

# Integer operations a scan needs at the least, for a bound: the three
# field tests of every offset; a lookup and an add for each Kraft field
# read; one for each header bit a full parse reads.
OPS_PER_OFFSET = 3
OPS_PER_KRAFT_FIELD = 2
OPS_PER_PARSED_BIT = 1


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def scan_headers(data, start_bit: int = 0, end_bit: int | None = None,
                 max_out: int = 64, *, device: str | torch.device = "cuda"
                 ) -> list[int]:
    """The first `max_out` bit offsets in [start_bit, end_bit) that hold a
    validated dynamic-block header, ascending: the list
    flate_tpu/native/__init__.py:scan_headers gives.

    data: bytes-like, or a 1-D uint8 tensor (then its own device is used)."""
    buf = _buffer(data, device)
    lo, hi = _range(buf.numel(), start_bit, end_bit)
    if max_out <= 0 or hi <= lo:
        return []
    if _build.use_plain(buf):
        return _scan_plain(_prepare(buf), lo, hi, max_out)
    return _scan_from_each(buf, lo, hi, max_out)


def chunk_entries(body, chunk_bytes: int, *,
                  device: str | torch.device = "cuda") -> list[int]:
    """[0] and the first validated header offset of each chunk k >= 1 of
    `body`, over [8 k chunk_bytes, 8 (k + 1) chunk_bytes): the chain heads
    flate_tpu/jx/anyinflate.py:365-373 builds.  On the card one launch
    covers every chunk."""
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    buf = _buffer(body, device)
    nchunks = max(1, -(-buf.numel() // chunk_bytes))
    step = 8 * chunk_bytes
    if _build.use_plain(buf):
        return _chunk_entries_plain(_prepare(buf), buf.numel(), chunk_bytes)
    lo, hi = _range(buf.numel(), step, nchunks * step)
    if hi <= lo:
        return [0]
    nseg = -(-(hi - lo) // step)
    return _first_per_chunk(_scan_cuda(buf, lo, step, hi, nseg).cpu(), nseg)


def _first_per_chunk(state: torch.Tensor, nseg: int) -> list[int]:
    """[0] and the first header of each segment that has one, from a
    state of _scan_cuda (on the host)."""
    firsts = ~state[STATE_HEAD:STATE_HEAD + nseg]
    return [0] + firsts[firsts >= 0].tolist()


def _buffer(data, device) -> torch.Tensor:
    """data as a 1-D uint8 tensor: a tensor as it is, bytes on `device`
    (a bytearray without a copy on the host)."""
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8 or data.dim() != 1:
            raise ValueError("scan: expected a 1-D uint8 tensor")
        return data
    dev = resolve_device(device)
    raw = data if isinstance(data, bytearray) else bytearray(data)
    if not raw:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    return torch.frombuffer(raw, dtype=torch.uint8).to(dev)


def _range(in_len: int, start_bit: int, end_bit: int | None):
    """The offsets the C tests: [start_bit, min(end_bit, nbits - 96))."""
    nbits = 8 * in_len
    end_bit = nbits if end_bit is None else min(end_bit, nbits)
    lim = nbits - TAIL_BITS if nbits > TAIL_BITS else 0
    return max(start_bit, 0), min(end_bit, lim)


# ---------------------------------------------------------------------------
# The kernel (CUDA data)
# ---------------------------------------------------------------------------

def _scan_cuda(buf: torch.Tensor, seg0: int, seg_len: int, hi: int,
               nseg: int) -> torch.Tensor:
    """One launch of scan_kernel; returns its state (int64, on the card):
    ~ the first header of each of the nseg segments [seg0 + k seg_len,
    min(seg0 + (k + 1) seg_len, hi))."""
    _build.check_cuda("scan data", buf, torch.uint8, (buf.numel(),))
    state = torch.zeros(STATE_HEAD + 2 * nseg, dtype=torch.int64,
                        device=buf.device)
    _build.launch("flate_scan_headers", buf.data_ptr(), state.data_ptr(),
                  buf.numel(), seg0, seg_len, hi, nseg)
    return state


def _scan_from_each(buf: torch.Tensor, lo: int, hi: int, max_out: int
                    ) -> list[int]:
    """scan_headers on the card: the first header of [lo, hi), then the
    first past it, and so on, a launch of one segment each, until max_out
    are found or none is left."""
    out: list[int] = []
    while len(out) < max_out and lo < hi:
        first = _first_per_chunk(_scan_cuda(buf, lo, hi - lo, hi, 1).cpu(),
                                 1)[1:]
        if not first:
            break
        out += first
        lo = first[0] + 1
    return out


# ---------------------------------------------------------------------------
# The plain version (CPU data; also what the kernel is held to on the card)
# ---------------------------------------------------------------------------

def _prepare(buf: torch.Tensor):
    """What the plain version reads: the bytes as int64 with 16 zero bytes
    after them (the cheap filter), and as bytes on the host (the parse)."""
    pad = torch.zeros(16, dtype=torch.uint8, device=buf.device)
    return torch.cat([buf, pad]).to(torch.int64), bytes(buf.cpu().numpy())


def _chunk_entries_plain(prep, in_len: int, chunk_bytes: int,
                         stats: dict | None = None) -> list[int]:
    """chunk_entries' list by the plain scan of each chunk k >= 1 up to its
    first header.  prep: _prepare's pair; stats: see _scan_plain."""
    step = 8 * chunk_bytes
    entries = [0]
    for k in range(1, max(1, -(-in_len // chunk_bytes))):
        lo, hi = _range(in_len, k * step, (k + 1) * step)
        if hi > lo:
            entries += _scan_plain(prep, lo, hi, 1, stats)
    return entries


def _scan_plain(prep, lo: int, hi: int, max_out: int,
                stats: dict | None = None) -> list[int]:
    """The cheap filter over the offsets of [lo, hi), window by window,
    then the full parse of its survivors in offset order until `max_out`
    pass.  prep: _prepare's pair.  stats, when given, counts what the scan
    needed: the offsets up to its stop, the Kraft fields of those that
    reach the Kraft test, the headers parsed and the bits each needed read
    before its answer was settled (_settled_bits), and the headers found
    and their bits (for the bound, ops_needed and bytes_needed)."""
    padded, data = prep
    out: list[int] = []
    w0, width = lo, FILTER_WINDOW0
    while w0 < hi:
        w1 = min(hi, w0 + width)
        width = min(2 * width, FILTER_WINDOW)
        tested, hclen, cand = _filter(padded, w0, w1)
        stop = w1
        parsed = parsed_bits = found_bits = 0
        found0 = len(out)
        for p in cand.tolist():
            ok, nb = _validate(data, p)
            parsed += 1
            if stats is not None:
                parsed_bits += nb if ok else _settled_bits(data, p)
            if ok:
                out.append(p)
                found_bits += nb
                if len(out) >= max_out:
                    stop = p + 1
                    break
        if stats is not None:
            stats["offsets"] = stats.get("offsets", 0) + stop - w0
            stats["kraft_fields"] = stats.get("kraft_fields", 0) + int(
                hclen[tested < stop].sum())
            stats["parsed"] = stats.get("parsed", 0) + parsed
            stats["parsed_bits"] = stats.get("parsed_bits", 0) + parsed_bits
            stats["found"] = stats.get("found", 0) + len(out) - found0
            stats["found_bits"] = stats.get("found_bits", 0) + found_bits
        if len(out) >= max_out:
            break
        w0 = w1
    return out


def _filter(padded: torch.Tensor, w0: int, w1: int):
    """The cheap filter of fastinflate.c:1055-1093 on offsets [w0, w1) of
    the int64 bytes `padded` (the data and 16 zero bytes).  Returns the
    offsets that reach the Kraft test, their HCLEN, and the offsets that
    pass it (ascending)."""
    dev = padded.device
    p = torch.arange(w0, w1, dtype=torch.int64, device=dev)
    byte = p >> 3
    v = (padded[byte] | (padded[byte + 1] << 8)
         | (padded[byte + 2] << 16)) >> (p & 7)       # bits p .. p + 16
    keep = (((v >> 1) & 3) == 2) & (((v >> 3) & 31) <= 29) \
        & (((v >> 8) & 31) <= 29)
    p, v = p[keep], v[keep]
    hclen = ((v >> 13) & 15) + 4
    kraft_lut = torch.tensor(KRAFT, dtype=torch.int64, device=dev)
    kraft = torch.zeros_like(p)
    for i in range(consts.NUM_CODEGEN):
        q = p + 17 + 3 * i
        b = q >> 3
        field = ((padded[b] | (padded[b + 1] << 8)) >> (q & 7)) & 7
        kraft += torch.where(i < hclen, kraft_lut[field], 0)
    return p, hclen, p[kraft == 128]


def _validate(data: bytes, p: int) -> tuple[bool, int]:
    """validate_dyn_header (fastinflate.c:1010) at BFINAL bit p: whether
    the header is valid, and the header bits it read.  The port's host
    header parser has the C's rules (separate length runs, a complete
    code-length code, one length-1 code the only incomplete code, reads
    past the end fail)."""
    bits = hinf._BitCursor(data, p + 3)
    try:
        ll_lens, d_lens = hinf.decode_dynamic_header_lens(bits)
        hinf.check_completeness(ll_lens, consts.MAX_CODE_BITS, True)
        hinf.check_completeness(d_lens, consts.MAX_CODE_BITS, False)
    except FlateError:
        return False, bits.pos - p - 3
    return True, bits.pos - p - 3


def _settled_bits(data: bytes, p: int) -> int:
    """The header bits after BTYPE that the parse at BFINAL bit p must read
    before its answer is settled: _validate's, but a length run stops at
    the symbol whose lengths take its Kraft sum past 1 (an over-subscribed
    code fails check_lens whatever follows; the sum only grows).  The
    reads and errors are decode_dynamic_header_lens', for the count
    alone."""
    bits = hinf._BitCursor(data, p + 3)
    try:
        hlit = bits.read(5) + 257
        hdist = bits.read(5) + 1
        hclen = bits.read(4) + 4
        if hlit > 286 or hdist > 30:
            raise FlateError()
        cl = np.zeros(consts.NUM_CODEGEN, dtype=np.int32)
        for i in range(hclen):
            cl[consts.CODEGEN_ORDER[i]] = bits.read(3)
        sym, nbits = hinf.build_decode_table(cl, consts.MAX_CODEGEN_BITS,
                                             is_litlen=False)
        for count, arr_len in ((hlit, 286), (hdist, 30)):
            pos = prev = kraft = 0
            while pos < count:
                code = bits.peek(consts.MAX_CODEGEN_BITS)
                s = int(sym[code])
                if s < 0:
                    raise FlateError()
                bits.consume(int(nbits[code]))
                if s < 16:
                    if pos >= arr_len:
                        raise FlateError()
                    n, prev = 1, s
                elif s == 16:
                    n = bits.read(2) + 3
                    if pos == 0 or pos + n > arr_len:
                        raise FlateError()
                elif s == 17:
                    n, prev = bits.read(3) + 3, 0
                else:
                    n, prev = bits.read(7) + 11, 0
                pos += n
                if prev:
                    kraft += n << (consts.MAX_CODE_BITS - prev)
                    if kraft > 1 << consts.MAX_CODE_BITS:
                        return bits.pos - p - 3
            if pos > count:
                break
    except FlateError:
        pass
    return bits.pos - p - 3


def ops_needed(stats: dict) -> int:
    """The integer operations a scan's data needs at the least, from the
    stats of its plain version."""
    return (OPS_PER_OFFSET * stats.get("offsets", 0)
            + OPS_PER_KRAFT_FIELD * stats.get("kraft_fields", 0)
            + OPS_PER_PARSED_BIT * stats.get("parsed_bits", 0))


def bytes_needed(stats: dict) -> int:
    """The bytes a scan's data needs moved at the least, from the stats of
    its plain version: the bytes its offsets up to the stop span, the
    headers found (BTYPE and their parse), and the list written as
    int64."""
    found = stats.get("found", 0)
    bits = stats.get("offsets", 0) + stats.get("found_bits", 0) + 3 * found
    return -(-bits // 8) + 8 * found
