"""Seeded inputs shared by the PyTorch-port parity tests (tests/test_torch_*).

Small shapes (shards of 4096 bytes, 512 bytes of context, batches of 2) as
in tests/test_fast_smoke.py; every corpus is built with numpy from a seed
so the JAX package and the port see the same bytes.
"""

from __future__ import annotations

import hashlib
import pathlib
import zlib

import numpy as np
import torch

S = 4096
CTX = 512
W = CTX + S
DATA = pathlib.Path(__file__).parent / "data"
KINDS = ("text", "random", "runs", "mixed")


def rfc_text() -> bytes:
    return (DATA / "rfc1951.txt").read_bytes()


def corpus(kind: str, n: int, seed: int = 0) -> bytes:
    """n bytes of one corpus kind: rfc1951 text, random bytes, long runs of
    one byte and of short periods (d in 1,2,3,4,8), or a mix of all."""
    rng = np.random.default_rng(seed)
    if kind == "text":
        t = rfc_text()
        off = int(rng.integers(0, len(t) - n)) if len(t) > n else 0
        return (t * (n // len(t) + 1))[off:off + n]
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "runs":
        out = bytearray()
        while len(out) < n:
            period = int(rng.choice([1, 2, 3, 4, 8]))
            unit = rng.integers(0, 256, period, dtype=np.uint8).tobytes()
            out += (unit * int(rng.integers(20, 700)))
            out += rng.integers(0, 256, int(rng.integers(0, 6)),
                                dtype=np.uint8).tobytes()
        return bytes(out[:n])
    if kind == "mixed":
        parts, total, k = [], 0, 0
        while total < n:
            sub = KINDS[k % 3]
            c = corpus(sub, 777 + 311 * k, seed + k + 1)
            parts.append(c)
            total += len(c)
            k += 1
        return b"".join(parts)[:n]
    raise ValueError(kind)


def windows(kind: str, B: int = 2, seed: int = 0) -> np.ndarray:
    """(B, W) uint8 window rows of one corpus kind."""
    raw = corpus(kind, B * W, seed)
    return np.frombuffer(raw, np.uint8).reshape(B, W).copy()


def tt(x) -> torch.Tensor:
    """numpy (or JAX) array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def u32(x) -> np.ndarray:
    """Any integer array (torch or numpy/JAX) as uint32 bit patterns."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


RING_CHUNK = 8192    # words a slot of the walks' shared-memory ring holds


def walk_edge_rows(N: int, chunk: int = RING_CHUNK, seed: int = 0):
    """Six rows of synthetic per-bit words (the serial walk's input: adv(6)
    | kind(2)<<6 | value(8)<<8 | dist(15)<<16, kinds literal and match
    only) whose chains land on the last word of every `chunk` (a run of 64
    one-bit steps before it; adv <= 63 cannot jump it), N >= 3 * chunk.
    Returns numpy (word (6, N) int32, start (6,), nbits (6,)):
      0: the edge words step 63, 1, 63, ...; the chain runs to the row's end;
      1: an end-of-block word first;
      2: start == nbits: no word;
      3: nbits > N, the walk starts in chunk 2;
      4: adv 0 on chunk 1's last word: the word repeats until NS;
      5: a whole chunk of one-bit steps, then an end-of-block word on
         chunk 2's last word; nbits = N - 5."""
    rng = np.random.default_rng(seed)
    B = 6
    adv = rng.integers(1, 64, (B, N))
    kind = rng.integers(0, 2, (B, N))
    value = rng.integers(0, 256, (B, N))
    dist = rng.integers(0, 1 << 15, (B, N))
    edges = np.arange(chunk - 1, N, chunk)
    for e in edges:
        adv[:, max(e - 64, 0):e] = 1
    adv[0, edges] = np.resize([63, 1], len(edges))
    adv[4, edges[1]] = 0
    adv[5, chunk:2 * chunk] = 1
    kind[5, edges[2]] = 2
    start = np.array([0, 5, 0, 2 * chunk + 7, 3, 17])
    kind[1, 5] = 2
    nbits = np.array([N, N, N - chunk - 3, N + 1000, N, N - 5])
    start[2] = nbits[2]
    word = adv | kind << 6 | value << 8 | dist << 16
    return (word.astype(np.int32), start.astype(np.int32),
            nbits.astype(np.int32))


def parse_edge_rows(R: int, n: int, seed: int = 0, jax_safe: bool = False
                    ) -> np.ndarray:
    """(R, n) int32 token steps (literals 1, matches 3..258) with an edge
    step on each row's chain (a run of 300 literals before it: no step
    jumps it), by row mod 6: 0 (taken as 1), n (ends the walk), 70,000,
    2^31 - 1, -5 (taken as 1), RING_CHUNK + 3 (skips a ring chunk on long
    rows).  jax_safe: steps the JAX kernel also takes (>= 1, sums within
    int32): 0 and -5 become 1, 2^31 - 1 becomes 100,000."""
    rng = np.random.default_rng(seed)
    step = np.where(rng.random((R, n)) < 0.6, 1,
                    rng.integers(3, 259, (R, n))).astype(np.int64)
    edge = [0, n, 70000, 2**31 - 1, -5, RING_CHUNK + 3]
    if jax_safe:
        edge = [1, n, 70000, 100000, 1, RING_CHUNK + 3]
    for r in range(R):
        p = (n // 3 + 97 * r) % n
        step[r, max(p - 300, 0):p] = 1
        step[r, p] = edge[r % 6]
    return step.astype(np.int32)


RUN_TILE = 4096      # positions a block of the small-runs kernel takes


def small_run_edge_rows(W: int, tile: int = RUN_TILE, seed: int = 0):
    """Four (W,) uint8 rows of two-letter noise with the small-distance
    runs' edges at every multiple of `tile` (a multiple of it is also the
    JAX kernel's 8,192-position tile), and their bounds.  Returns numpy
    (window (4, W) uint8, limit (4,) int32, min_src (4,) int32):
      0: runs of 259, 257 and 258 equal bytes (d = 1) and of periods 2, 3,
         4 and 8, each crossing a tile end; limit W, min_src 0;
      1: the same runs; limit 40 bytes past the first tile end, inside the
         run of 259 that crosses it (when W < tile the row has one "tile
         end", at W // 2);
      2: a period-8 run from 3 bytes before every tile start (d = 8 within
         8 bytes of it); min_src 100 bytes into the second tile (into the
         row when W < tile), limit 200 bytes past the first tile end,
         inside the 257-byte halo a run of the first tile may read;
      3: all zeros (every run is as long as the bounds allow); limit <=
         min_src."""
    rng = np.random.default_rng(seed)
    win = rng.integers(0, 2, (4, W)).astype(np.uint8) + 60
    ends = list(range(tile, W, tile)) or [W // 2]
    lens = (259, 257, 258)
    for r in (0, 1):
        for k, e in enumerate(ends):
            n = lens[k % 3]
            lo = max(e - n // 2 - k % 5, 0)
            win[r, lo:lo + n] = 7 + k
            if lo > 600:                   # a period run before it
                period = (2, 3, 4, 8)[k % 4]
                unit = np.arange(period, dtype=np.uint8) + 20
                win[r, lo - 560:lo - 270] = np.resize(unit, 290)
    for e in [0, *ends]:
        seg = win[2, max(e - 3, 0):e + 297]
        seg[:] = np.resize(np.arange(8, dtype=np.uint8) + 30, len(seg))
    win[3] = 0
    cut = ends[0] + 40 if ends[0] < W else W - 100
    limit = np.array([W, min(W, cut), min(W, ends[0] + 200), 50], np.int32)
    min_src = np.array([0, 0, min(W - 1, (tile if W > tile else 0) + 100),
                        60], np.int32)
    return win, limit, min_src


def lane_edge_rows(G: int, NL: int, seed: int = 0):
    """Six rows of NL lanes of G positions of synthetic per-bit words (adv
    1..40 in the low 6 bits, the rest noise), with the lane walk's edges.
    Returns numpy (word (6, NL * G) int32, start (6,), nbits (6,)):
      0: every lane ends in a run of one-bit steps with one jump of 63 at
         a lane-dependent place, so its chain leaves the lane 0..62
         positions past its end (lane l: 62 - l % 63), and starts with a
         run of one-bit steps, so the next lane joins at once; start 0;
      1: random advances: joins take walking; start 3 (inside a symbol);
      2: start in lane 1, 5 positions in; nbits ends mid-lane 2 (lane 1
         when NL < 3);
      3: start in the last lane; nbits N;
      4: start past nbits (in the lane after the one nbits ends in);
      5: nbits 0."""
    rng = np.random.default_rng(seed)
    N = NL * G
    adv = rng.integers(1, 41, (6, N))
    lanes = adv[0].reshape(NL, G)
    lanes[:, :64] = 1
    lanes[:, G - 128:] = 1
    for l in range(NL):
        lanes[l, G - 1 - (l % 63)] = 63
    word = adv | (rng.integers(0, 1 << 26, (6, N)) << 6)
    mid = min(2, NL - 1) * G + G // 2 + 1
    start = np.array([0, 3, min(1, NL - 1) * G + 5, (NL - 1) * G + 11,
                      (mid // G + 1) * G + 9, 0])
    nbits = np.array([N, N, mid, N, mid, 0])
    return (word.astype(np.int32), start.astype(np.int32),
            nbits.astype(np.int32))


PACK_TILE = 4096     # fields a block of the bit-pack kernel takes
PACK_EDGES = ("straddle", "dead_tile", "word_end", "word_start",
              "one_word_tile", "empty", "full")


def _fields_to(bits: np.ndarray, f: int, target: int) -> None:
    """Set the widths of fields f-2 and f-1 (both live) so that field f
    starts at bit target mod 32."""
    d = (target - int(bits[:f - 2].sum())) % 32
    d += 32 if d < 2 else 0
    bits[f - 2], bits[f - 1] = d // 2, d - d // 2


def pack_edge_rows(slots: int, max_bits: int, tile: int = PACK_TILE,
                   seed: int = 0):
    """(vals uint32, bits int32) rows of bit-pack fields, one per name of
    PACK_EDGES, at every tile end of `tile` fields: `straddle` (random
    widths, the fields on each side of every tile end laid across a word
    boundary), `dead_tile` (as straddle, the second tile's fields dead),
    `word_end` (the stream is the first tile's fields, 8 bits each: it ends
    on a word boundary at the tile end), `word_start` (as word_end, then
    random fields: the second tile starts a word), `one_word_tile` (the
    second tile holds 3 live fields, 12 bits within one word), `empty` (no
    live field) and `full` (28-bit fields to the end).  Fields whose end
    passes max_bits are dead, so the stream fits the word grid; values fit
    their widths, dead fields are zero."""
    rng = np.random.default_rng(seed)
    wmax = int(np.clip(2 * max_bits // slots - 1, 1, 28))
    rows = []
    for name in PACK_EDGES:
        bits = rng.integers(1, wmax + 1, slots).astype(np.int64)
        if name in ("straddle", "dead_tile"):
            for end in range(tile, slots, tile):
                bits[end - 1] = bits[end] = 28
                _fields_to(bits, end - 1, 30)
            if name == "dead_tile":
                bits[tile:2 * tile] = 0
        elif name in ("word_end", "word_start"):
            bits[:tile] = 8
            if name == "word_end":
                bits[tile:] = 0
        elif name == "one_word_tile":
            bits[tile:2 * tile] = 0
            bits[[tile + 5, tile + 100, 2 * tile - 1]] = [3, 5, 4]
            _fields_to(bits, tile, 7)
        elif name == "empty":
            bits[:] = 0
        else:
            bits[:] = 28
        bits = np.where(np.cumsum(bits) <= max_bits, bits, 0)
        vals = rng.integers(0, 2**28, slots, dtype=np.int64)
        vals = np.where(bits > 0, vals & ((1 << bits) - 1), 0)
        rows.append((vals, bits))
    vals = np.stack([r[0] for r in rows]).astype(np.uint32)
    bits = np.stack([r[1] for r in rows]).astype(np.int32)
    return vals, bits


# ---------------------------------------------------------------------------
# hand-built dynamic-block headers (the chunk-entry scanner's cases)
# ---------------------------------------------------------------------------

CODEGEN_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14,
                 1, 15)


def _rle(lens) -> list:
    """The code-length symbols (sym, extra value, extra bits) of one run of
    lengths, zlib-style: zeros as 17/18, repeats of a length as 16."""
    out, i, n = [], 0, len(lens)
    while i < n:
        v, j = int(lens[i]), i
        while j < n and lens[j] == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                out.append((18, r - 11, 7))
                run -= r
            if run >= 3:
                out.append((17, run - 3, 3))
                run = 0
        else:
            out.append((v, 0, 0))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                out.append((16, r - 3, 2))
                run -= r
        out += [(v, 0, 0)] * run
        i = j
    return out


def _balanced(syms) -> dict:
    """A complete code over `syms` (two or more): the balanced one."""
    k = len(syms)
    d = (k - 1).bit_length()
    m = (1 << d) - k                     # leaves one level up
    return {s: d - 1 if i < m else d for i, s in enumerate(sorted(syms))}


def canonical_code(lens: dict) -> dict:
    """sym -> (code, len) of the canonical code of `lens` (MSB-first)."""
    code, out = 0, {}
    for ln in range(1, 16):
        for s in sorted(s for s, n in lens.items() if n == ln):
            out[s] = (code, ln)
            code += 1
        code <<= 1
    return out


def dyn_header(ll_lens, d_lens, *, bfinal: int = 1, cl_lens=None,
               hclen: int | None = None, hlit: int | None = None,
               cross: bool = False) -> list:
    """The bits (LSB-first order) of a dynamic-block header with these
    literal/length and distance lengths.  cl_lens: the 19 code-length
    code lengths (default: a complete code over the symbols used); hclen,
    hlit: raw field values in place of the computed ones; cross: send the
    first three distance lengths as a repeat-16 of the last
    literal/length length (RFC 1951 lets a repeat cross that boundary;
    the C scanner does not)."""
    bits: list = []

    def put(v, n):                       # a field, LSB-first
        bits.extend((int(v) >> i) & 1 for i in range(n))

    syms = _rle(ll_lens)
    if cross:
        syms += [(16, 0, 2)] + _rle(d_lens[3:])
    else:
        syms += _rle(d_lens)
    if cl_lens is None:
        used = sorted({s for s, _, _ in syms} | {0, 1})
        lens = _balanced(used)
        cl_lens = [lens.get(s, 0) for s in range(19)]
    if hclen is None:
        hclen = max(4, max(i + 1 for i, s in enumerate(CODEGEN_ORDER)
                           if cl_lens[s]))
    put(bfinal, 1)
    put(2, 2)
    put(len(ll_lens) - 257 if hlit is None else hlit, 5)
    put(len(d_lens) - 1, 5)
    put(hclen - 4, 4)
    for i in range(hclen):
        put(cl_lens[CODEGEN_ORDER[i]], 3)
    codes = canonical_code({s: n for s, n in enumerate(cl_lens) if n})
    for s, extra, nx in syms:
        code, ln = codes.get(s, (0, 1))
        bits.extend((code >> (ln - 1 - i)) & 1 for i in range(ln))
        put(extra, nx)
    return bits


def with_eob(bits: list, ll_lens) -> list:
    """Header bits followed by the code of symbol 256 under ll_lens: a
    block with no data."""
    code, ln = canonical_code({s: n for s, n in enumerate(ll_lens) if n})[256]
    return bits + [(code >> (ln - 1 - i)) & 1 for i in range(ln)]


def header_stream(bits: list, lead: int, tail: int, seed: int = 0
                  ) -> bytes:
    """`lead` random bits, the header bits, then random bytes to fill
    `tail` more bytes."""
    rng = np.random.default_rng(seed)
    allb = list(rng.integers(0, 2, lead)) + list(bits)
    allb += list(rng.integers(0, 2, (-len(allb)) % 8 + 8 * tail))
    return np.packbits(np.asarray(allb, np.uint8),
                       bitorder="little").tobytes()


def deflate_raw(data: bytes, level: int, strategy: int = 0) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return c.compress(data) + c.flush()


# A complete literal/length code (255 codes of 8 bits, 255 and 256 of 9)
# and a complete distance code (4 of 2 bits).
HDR_LL = [8] * 255 + [9, 9]
HDR_D = [2, 2, 2, 2]


def header_cases() -> dict:
    """name -> (lengths and options for dyn_header, whether the C scanner
    accepts the header): one accepted header and one case per rejection
    of the C's parse."""
    one_ll = [0] * 257
    one_ll[256] = 1
    no_eob = list(HDR_LL)
    no_eob[256] = 0
    no_eob[100] = 9                      # keep the code complete
    # symbols 256 and 257 of length 2, as long as the distance codes
    cross_ll = [9] * 256 + [2, 2]
    over = [0] * 19
    under = [0] * 19
    for s in (0, 1, 2, 8, 9, 16, 17, 18):
        over[s], under[s] = 2, 4         # 8 codes of 2 bits / of 4 bits
    return {
        "accepted": ((HDR_LL, HDR_D, {}), True),
        "hlit_30": ((HDR_LL, HDR_D, {"hlit": 30}), False),
        "hlit_31": ((HDR_LL, HDR_D, {"hlit": 31}), False),
        "codelen_over": ((HDR_LL, HDR_D, {"cl_lens": over}), False),
        "codelen_under": ((HDR_LL, HDR_D, {"cl_lens": under}), False),
        "cross_ll": ((cross_ll, HDR_D, {}), True),
        "repeat16_first_dist": ((cross_ll, HDR_D, {"cross": True}), False),
        "no_code_256": ((no_eob, HDR_D, {}), False),
        "lone_dist_len1": ((HDR_LL, [1], {}), True),
        "incomplete_dist": ((HDR_LL, [1, 2], {}), False),
        "zero_dist": ((HDR_LL, [0, 0, 0], {}), True),
        "lone_litlen_len1": ((one_ll, HDR_D, {}), True),
        "incomplete_litlen": ((HDR_LL[:-1] + [0], HDR_D, {}), False),
        "bfinal_0": ((HDR_LL, HDR_D, {"bfinal": 0}), True),
    }


def header_case_stream(name: str, lead: int = 13, tail: int = 24) -> bytes:
    """The stream of header case `name`: `lead` random bits, the header,
    `tail` random bytes."""
    (ll, d, kw), _ = header_cases()[name]
    return header_stream(dyn_header(ll, d, **kw), lead, tail,
                         seed=len(name))


def edge_stream(lead: int, nbits: int = 112) -> bytes:
    """A 93-bit valid header (only symbol 256 and one distance code, both
    of length 1) at bit `lead` of an nbits-bit stream of random bits: the
    C tests it only when lead < nbits - 96."""
    one_ll = [0] * 257
    one_ll[256] = 1
    bits = dyn_header(one_ll, [1])
    rng = np.random.default_rng(lead)
    allb = list(rng.integers(0, 2, lead)) + bits
    allb += list(rng.integers(0, 2, nbits - len(allb)))
    return np.packbits(np.asarray(allb, np.uint8),
                       bitorder="little").tobytes()


def scan_cases() -> dict:
    """name -> (data, start_bit, end_bit, max_out) of the chunk-entry
    scanner's cases: deflate bodies of CPython's zlib at levels 0, 1, 6, 9
    and Z_FIXED, random bytes, unaligned starts, ranges that end at a
    header or in the last 96 bits, streams under 96 bits, a header just
    below, at and above nbits - 96, and the hand-built headers."""
    text = corpus("text", 200_000)
    mixed = corpus("mixed", 200_000, seed=5)
    cases = {}
    for lv in (1, 6, 9):
        cases[f"text_l{lv}"] = (deflate_raw(text, lv), 0, None, 64)
        cases[f"mixed_l{lv}"] = (deflate_raw(mixed, lv), 0, None, 1000)
    cases["stored_l0"] = (deflate_raw(text[:100_000], 0), 0, None, 64)
    cases["fixed"] = (deflate_raw(text, 6, zlib.Z_FIXED), 0, None, 64)
    rng = np.random.default_rng(17)
    cases["random_64k"] = (rng.integers(0, 256, 1 << 16, dtype=np.uint8)
                           .tobytes(), 0, None, 1000)
    body = cases["mixed_l1"][0]
    for s in (3, 8 * 20_000 + 5, 8 * 20_000 + 13):
        cases[f"start_{s}"] = (body, s, None, 4)
    hs = header_case_stream("accepted", lead=13, tail=40)   # header at 13
    for s, e in ((13, None), (14, None), (5, 13), (5, 14)):
        cases[f"hdr_range_{s}_{e}"] = (hs, s, e, 64)
    nb = 8 * len(hs)
    for e in (nb - 50, nb - 96, nb - 97, nb + 1000):
        cases[f"hdr_end_{e - nb:+d}"] = (hs, 0, e, 64)
    for lead in (15, 16, 17):            # nbits - 97, - 96, - 95
        cases[f"edge_{lead}"] = (edge_stream(lead), 0, None, 64)
        cases[f"edge_{lead}_end"] = (edge_stream(lead), 0, 100, 64)
    cases["hdr_truncated"] = (hs[:30], 0, None, 64)   # reads past the end
    hb = header_case_stream("accepted", lead=13, tail=0)
    for cut in (0, 1, 11, 12, 13):
        cases[f"short_{cut}"] = (hb[:cut], 0, None, 64)
    for name in header_cases():
        cases[f"hdr_{name}"] = (header_case_stream(name), 0, None, 64)
    return cases


def trap_stream() -> bytes:
    """A zlib stream of stored blocks (4 KiB flushes) whose payload holds,
    at ~40 KB, a valid dynamic header with BFINAL 0, its end-of-block code
    and then the bits of a block type 3: the scanner's entry for chunk 1
    at 32 KiB, whose chain fails at its second block."""
    bits = with_eob(dyn_header(HDR_LL, HDR_D, bfinal=0), HDR_LL)
    bits += [0, 1, 1]                    # BFINAL 0, BTYPE 3
    bits += [0] * ((-len(bits)) % 8)
    trap = np.packbits(np.asarray(bits, np.uint8), bitorder="little")
    payload = corpus("text", 40000) + trap.tobytes() \
        + corpus("text", 8000, seed=1)
    c = zlib.compressobj(0, zlib.DEFLATED, 15)
    return b"".join(c.compress(payload[i:i + 4096])
                    + c.flush(zlib.Z_FULL_FLUSH)
                    for i in range(0, len(payload), 4096)) + c.flush()


def long_run_text(n: int = 1_500_000, seed: int = 0) -> bytes:
    """Text with runs of zeros and of short periods, 60-300 KB each,
    between its paragraphs: blocks of several hundred KB of output whose
    matches are long."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += corpus("text", int(rng.integers(2000, 40000)),
                      seed=int(rng.integers(1 << 30)))
        unit = bytes(rng.integers(0, 256, int(rng.choice([1, 1, 3, 8])),
                                  dtype=np.uint8))
        out += unit * (int(rng.integers(60_000, 300_000)) // len(unit))
    return bytes(out[:n])


def big_block_streams() -> dict:
    """name -> (container name, stream): chip_smoke.py's streams whose
    blocks hold more than 4 MiB of output or more symbols than twice
    their compressed bytes, which phase 14 decodes on the card."""
    from chip_smoke import big_block_streams as streams
    return {name: (container, blob)
            for name, container, blob, _ in streams()}


def long_block_streams(text_size: int = 300_000,
                       mixed_size: int = 400_000) -> dict:
    """name -> (container name, stream, input): chip_smoke.py's one-block
    streams of the port's host writer, whose blocks pass MAX_SPAN (phase
    14 decodes them at 12 and 6 MiB), here 164 and 183 KB blocks: more
    than MAX_SPAN once a test cuts it to 64 KiB."""
    from chip_smoke import long_block_streams as streams
    return {name: (container, blob, data)
            for name, container, blob, data in streams(text_size,
                                                       mixed_size)}


def placed_headers(nbytes: int, offsets, name: str = "accepted") -> bytes:
    """nbytes of zero bytes (no offset passes the first test) with header
    case `name` and its end-of-block code at each bit offset."""
    (ll, d, kw), _ = header_cases()[name]
    bits = np.asarray(with_eob(dyn_header(ll, d, **kw), ll), np.uint8)
    allb = np.zeros(8 * nbytes, np.uint8)
    for p in offsets:
        allb[p:p + len(bits)] = bits
    return np.packbits(allb, bitorder="little").tobytes()


SCAN_TILE = 2048     # offsets a tile of the chunk-entry scanner takes


def scan_edge_cases() -> dict:
    """name -> (data, start_bit, end_bit, max_out, chunk sizes) for the
    chunk-entry scanner's tiles and early stops: headers at a tile's last
    offset, at a chunk's last offset (its parse reads into the next
    chunk), a chunk with none, max_out reached inside a tile, an end not a
    multiple of 32, an all-zero and a random body."""
    T, c = SCAN_TILE, 1024               # 1 KiB chunks: 4 tiles a chunk
    step = 8 * c
    chunked = placed_headers(6 * c + 200, [
        step + T - 1,                    # chunk 1: its first tile's last
        3 * step - 1,                    # chunk 2: its last offset
        3 * step + 600,                  # chunk 3: past the one above
        5 * step + 2 * T - 1])           # chunk 4 none; chunk 5: tile 1
    tiles = placed_headers(4096, [T - 1, 2 * T - 1, 3 * T + 7])
    dense = placed_headers(1024, [100, 600, 1100, 1600, 2100, 4000])
    body = scan_cases()["mixed_l1"][0]
    rng = np.random.default_rng(23)
    return {
        "chunk_edges": (chunked, 0, None, 64, (c, 2 * c)),
        "tile_last": (tiles, 0, None, 64, (512, 1024)),
        "tile_last_from_1": (tiles, 1, None, 64, (512,)),
        "max_out_mid_tile_2": (dense, 0, None, 2, (256,)),
        "max_out_mid_tile_5": (dense, 3, None, 5, (256,)),
        "hi_not_32": (body, 5, 8 * 100_000 + 13, 1000, (32768,)),
        "all_zero": (bytes(1 << 20), 0, None, 64, (32768, 131072)),
        "random": (rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
                   0, None, 1000, (32768, 131072)),
    }


def too_far_streams() -> dict:
    """container name -> stream: chip_smoke.py's raw and zlib streams of a
    match that reaches before the stream's start (InvalidMatch)."""
    from chip_smoke import too_far_streams as streams
    return dict(streams())


def small_blocks(data: bytes, wbits: int = 15, mem_level: int = 2,
                 level: int = 6) -> bytes:
    """zlib's stream of `data` at a low memLevel: blocks of at most
    2^(mem_level + 6) - 1 symbols, a few hundred bytes each, so a small
    decode window holds several."""
    c = zlib.compressobj(level, zlib.DEFLATED, wbits, mem_level)
    return c.compress(data) + c.flush()


def c12_stream() -> bytes:
    """A Huffman-only raw stream of 50,000 random bytes below 64 (seed 12)
    whose last 3 bytes are 0xFF: its final block ends a byte before the
    end, and the byte left over reads as a block of type 3."""
    data = np.random.default_rng(12).integers(0, 64, 50_000,
                                              dtype=np.uint8).tobytes()
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    return (c.compress(data) + c.flush())[:-3] + b"\xff" * 3


def _batches(data: bytes, shard_len: int, ctx: int, batch: int):
    """compress_device2's batches of `data`: (shards (batch, S) uint8, ctx0
    (ctx,) uint8, meta (3 batch + 1,) int32 = [ctx_lens | valid | finals |
    nb]) numpy arrays, the context carried from the input bytes as the
    device carry gives it."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n, S = arr.size, shard_len
    nshards = max(1, -(-n // S))
    for base in range(0, nshards, batch):
        nb = min(batch, nshards - base)
        lo0 = base * S
        shards = np.zeros(batch * S, dtype=np.uint8)
        take_n = max(0, min(n - lo0, batch * S))
        shards[:take_n] = arr[lo0:lo0 + take_n]
        ctx0 = np.zeros(ctx, dtype=np.uint8)
        c0 = min(ctx, lo0)
        if c0:
            ctx0[ctx - c0:] = arr[lo0 - c0:lo0]
        meta = np.zeros(3 * batch + 1, dtype=np.int32)
        meta[:batch] = np.minimum(ctx, lo0 + np.arange(batch) * S)
        for i in range(nb):
            meta[batch + i] = max(0, min(S, n - (base + i) * S))
        if base + nb == nshards:
            meta[2 * batch + nb - 1] = 1
        meta[3 * batch] = nb
        yield shards.reshape(batch, S), ctx0, meta


def encode_stages(data: bytes, level: int, shard_len: int, ctx: int,
                  batch: int, device, container: str = "GZIP") -> list:
    """Every batch of compress_device2(data, level, container, shard_len,
    ctx, batch) through encode_core's stages in order, on `device`: a list
    of (batch index, stage name, tensor) — the primed windows, B1's keys
    and fingerprints, the key sort, B2's best (len << 16) - dist (and the
    3-byte pass's, from level 7), B3's runs, B4's extended matches, the
    truncated matches, decide's take, B9's token starts, the squeeze's
    greedy code lengths and parse, build_fields' vals / bits / total_bits
    / kind, B5's words and bit counts, and the compacted bytes with the
    container's device checksum (CRC32 of the padded rows for GZIP, Adler
    sums for ZLIB).  Imports only the port."""
    from flate_tpu_torch.device import (encode2, match2, pack, parse,
                                        pipeline2, runs, squeeze)
    hash_kind = {"GZIP": pipeline2.HASH_CRC32, "ZLIB": pipeline2.HASH_ADLER32
                 }.get(container, pipeline2.HASH_NONE)
    kn = pipeline2.level_params(level, shard_len)
    S, blk = shard_len, kn["blk"]
    out = []
    for j, (sh, c0, mt) in enumerate(_batches(data, S, ctx, batch)):
        def put(name, t):
            out.append((j, name, t))
        shards = torch.from_numpy(sh).to(device)
        meta = torch.from_numpy(mt).to(device)
        ctx_lens, valid, finals, nb = pipeline2._split_meta(meta)
        win = pipeline2._prime_windows(shards, torch.from_numpy(c0).to(
            device), ctx)
        put("prime_windows", win)
        min_src = (ctx - ctx_lens).to(torch.int32)
        limit = (ctx + valid).to(torch.int32)
        W = win.shape[1]
        passes = [("", kn["K"], kn["nw"], 4, 32768)]
        if kn["K3"]:
            passes.append(("k3_", kn["K3"], 1, 3, 4096))
        best = []
        for tag, K, nw, hb, md in passes:
            key, fps = match2._prep(win, nw, hb)
            put(f"{tag}prep_keys", key)
            put(f"{tag}prep_fps", fps)
            skey, order = torch.sort(key, dim=1)
            put(f"{tag}key_sort", skey)
            ld = match2._run_matcher(skey, order, win, fps, min_src, limit,
                                     W, K, md, nw, hb)
            put(f"{tag}matcher", ld)
            best.append(ld)
        mlen, mdist = best[0] >> 16, best[0] & 0xFFFF
        if kn["K3"]:
            l3 = torch.clamp(best[1] >> 16, max=3)
            d3 = best[1] & 0xFFFF
            upd3 = match2._score(l3, d3) > match2._score(mlen, mdist)
            mlen, mdist = torch.where(upd3, l3, mlen), torch.where(
                upd3, d3, mdist)
        rlen, rdist = runs.small_dist_runs(win, limit, min_src)
        put("small_runs", torch.stack([rlen, rdist]))
        upd = match2._score(rlen, rdist) > match2._score(mlen, mdist)
        mlen = torch.where(upd, rlen, mlen).contiguous()
        mdist = torch.where(upd, rdist, mdist).contiguous()
        mlen = runs.extend_chains(mlen, mdist, limit, cap=4 * kn["nw"])
        drop = (mlen == 3) & (mdist > 4096)
        mlen, mdist = torch.where(drop, 0, mlen), torch.where(drop, 0, mdist)
        put("extend", torch.stack([mlen, mdist]))
        ref = match2.find_matches_fused(win, ctx_lens, valid, K=kn["K"],
                                        nw=kn["nw"], ctx=ctx, K3=kn["K3"])
        if not (torch.equal(ref[0], mlen) and torch.equal(ref[1], mdist)):
            raise AssertionError("encode_stages: the matcher stages no "
                                 "longer compose to find_matches_fused")
        mlen, mdist = parse.truncate_matches(mlen, mdist, ctx, blk)
        put("truncate", torch.stack([mlen, mdist]))
        take, _ = parse.decide(mlen, mdist, kn["lazy"], kn["max_lazy"])
        put("decide", take)
        starts = parse.parse_blocks(mlen, mdist, start=ctx, lazy=kn["lazy"],
                                    max_lazy=kn["max_lazy"], blk=blk)
        put("parse_blocks", starts)
        tail = win[:, ctx:]
        m_r, d_r = mlen[:, ctx:], mdist[:, ctx:]
        take_r, starts_r = take[:, ctx:], starts[:, ctx:]
        if kn["squeeze"]:
            ll_bits, d_bits = squeeze.greedy_code_lengths(
                tail, m_r, d_r, starts_r, take_r, valid)
            put("greedy_ll_bits", ll_bits)
            put("greedy_d_bits", d_bits)
            take_r, starts_r, sel = squeeze.squeeze_parse(
                tail, m_r, d_r, ll_bits, d_bits, blk=blk,
                grid_only=squeeze.grid_only_default())
            m_r = torch.where(take_r, sel, 0)
            put("squeeze_parse", torch.stack([take_r.to(torch.int32),
                                              starts_r.to(torch.int32),
                                              m_r.to(torch.int32)]))
        seg = encode2.seg_size(S, blk)
        vals, bits, total, kind = encode2.build_fields(
            tail, m_r, d_r, starts_r, take_r, valid, finals, S, seg)
        put("build_fields_vals", vals)
        put("build_fields_bits", bits)
        put("build_fields_total_bits", total)
        put("build_fields_kind", kind)
        words, tbits = pack.pack_fields(vals, bits, pipeline2._nwr(S, seg))
        put("pack_words", words)
        put("pack_tbits", tbits)
        buf, meta_out = pipeline2._compact_stage(words, tbits, shards, valid,
                                                 nb, hash_kind=hash_kind)
        put("compact_bytes", buf[:int(meta_out[0])])
        put("compact_meta", meta_out)
    return out


def first_stage_difference(data: bytes, level: int, shard_len: int,
                           ctx: int, batch: int, device,
                           container: str = "GZIP") -> str | None:
    """The first stage of encode_stages whose tensor on `device` differs
    from the CPU's, named with its batch and the count of differing
    entries, or None where every stage agrees."""
    a = encode_stages(data, level, shard_len, ctx, batch, device, container)
    b = encode_stages(data, level, shard_len, ctx, batch, "cpu", container)
    for (j, name, x), (_, _, y) in zip(a, b):
        x = x.cpu()
        if x.shape != y.shape:
            return f"batch {j} {name}: shape {tuple(x.shape)} != " \
                   f"{tuple(y.shape)}"
        ne = int((x.to(torch.int64) != y.to(torch.int64)).sum())
        if ne:
            return f"batch {j} {name}: {ne} of {x.numel()} entries differ"
    return None


# ---------------------------------------------------------------------------
# the encode's shard-shape sweep: the shapes of the JAX package's own tests
# ---------------------------------------------------------------------------

SWEEP_SHARDS = (1024, 2048, 4096, 7168, 16384, 131072)
SWEEP_CTX = (512, 1024, 4096, 8192, 32768)
SWEEP_BATCH = (1, 2, 3, 8)
SWEEP_LEVELS = tuple(range(1, 10))
CONTAINERS = ("RAW", "ZLIB", "GZIP")
SWEEP_INPUTS = ("fuzz_mixed", "mixed", "text", "zeros", "random", "empty",
                "one", "hundred")
WBITS = {"GZIP": 31, "ZLIB": 15, "RAW": -15}


SQUEEZE_CASES = ("ties0", "ties1", "ties2", "blk256", "ragged", "no_match",
                 "all15")


def _squeeze_matches(rng, B: int, n: int, blk: int, dist):
    """Match lengths, half on the squeeze's grid and half uniform in
    0..258, cut at their parse block's end (below 3: no match), and a
    distance from `dist` (B, n) where there is a match."""
    from flate_tpu_torch.device.squeeze import GRID
    grid = np.asarray(GRID)
    ml = np.where(rng.random((B, n)) < 0.5, rng.choice(grid, (B, n)),
                  rng.integers(0, 259, (B, n)))
    room = blk - (np.arange(n) % blk)
    ml = np.minimum(ml, room[None, :])
    ml = np.where(ml < 3, 0, ml).astype(np.int32)
    md = np.where(ml > 0, dist((B, n)), 0).astype(np.int32)
    return ml, md


def squeeze_case(name: str):
    """squeeze_parse's inputs (window_tail uint8, mlen, mdist, ll_bits,
    d_bits int32, blk) for one of SQUEEZE_CASES:

    ties<seed>: flat code lengths, so that literal runs, the full length
      and grid lengths tie (a length code costs two literals, distance
      codes 0 or 2 bits), with an unseen byte (length 0 -> 15);
    blk256: a small shard's fitted parse block, 256, over 3 rows of 8
      blocks; code lengths 1-15 and distances over every distance code;
    ragged: as blk256 with a 1,000-byte shard's block, 1,000 (not a
      multiple of the kernel's tiles), 2 rows of 2 blocks;
    no_match: as blk256 at blk 1,024, but the second block of row 0 has
      no match at all;
    all15: every code length 15 at blk 4,096 and 1 % of the matches, none
      past the first 256 positions of the last block: the largest costs,
      up to 15 * 4,096 = 61,440, with matches to choose there."""
    if name.startswith("ties"):
        seed = int(name[4:])
        rng = np.random.default_rng(seed)
        B, blk = 2, 1024
        wt = rng.integers(0, 4, (B, 2 * blk), dtype=np.uint8)
        ml, md = _squeeze_matches(rng, B, 2 * blk, blk,
                                  lambda shape: rng.choice([1, 2, 5, 9],
                                                           shape))
        ll = np.full((B, 286), 2 + seed, np.int32)
        ll[:, 257:] = 4 + 2 * seed                 # len code = two literals
        ll[0, 3] = 0                               # an unseen byte
        dd = np.zeros((B, 30), np.int32)           # distance codes: 0 bits
        dd[1] = 2
        return wt, ml, md, ll, dd, blk
    B, blk, n = {"blk256": (3, 256, 2048), "ragged": (2, 1000, 2000),
                 "no_match": (2, 1024, 2048), "all15": (2, 4096, 8192)}[name]
    rng = np.random.default_rng(SQUEEZE_CASES.index(name))
    wt = rng.integers(0, 256, (B, n), dtype=np.uint8)
    ml, md = _squeeze_matches(
        rng, B, n, blk,
        lambda shape: np.minimum(2.0 ** (15 * rng.random(shape)) + 1, 32768))
    if name == "all15":
        ll = np.full((B, 286), 15, np.int32)
        dd = np.full((B, 30), 15, np.int32)
    else:
        ll = rng.integers(1, 16, (B, 286), dtype=np.int32)
        dd = rng.integers(1, 16, (B, 30), dtype=np.int32)
    if name == "no_match":
        ml[0, blk:2 * blk] = 0
    if name == "all15":
        ml[rng.random((B, n)) >= 0.01] = 0
        ml[-1, 256 - blk:] = 0
    md[ml == 0] = 0
    return wt, ml, md, ll, dd, blk


def squeeze_flip() -> bytes:
    """22,762 bytes on which the squeeze's code lengths decide the level-6
    bytes (ROADMAP C.18): in one shard of 32,768 the greedy parse has
    22,723 tokens (total 22,724 with the EOB) and 0x7E 5 times among its
    literals, a pair where the jitted JAX code length is 12 bits and the
    correctly rounded log2's 13.  At 20,000, "\x7eeta" repeats at distance
    20: a match of 4 that costs 15 + 3 + 3 bits (its length code seen
    once, its distance code one of 5 matches, 3 extra bits), against 12 +
    3 + 3 + 3 for its literals (e, t, a are a sixth of the bytes each).
    At 12 bits the DP keeps the literals (the first of equal costs), at 13
    it takes the match.  The other bytes repeat no 3-gram, so the only
    other matches are four 10-byte copies at distances 100, 300, 700 and
    1,500; a byte next to a planted run is drawn so as not to lengthen
    its match."""
    rng = np.random.default_rng(18)
    x, common = 0x7E, (0x65, 0x74, 0x61)
    lits = {p: (x,) for p in (2_000, 11_000, 14_000, 17_000)}
    lits[19_980] = (x,) + common
    copies = {20_000: (20, 4)}            # position: (distance, length)
    for i, d in enumerate((100, 300, 700, 1_500)):
        copies[3_500 + 1_500 * i] = (d, 10)
    out, seen = [], set()

    def planted(p):
        if p in copies:
            d, n = copies[p]
            return out[p - d:p - d + n]
        return list(lits.get(p, ()))

    while len(out) < 22_762:
        run = planted(len(out))
        if not run:
            c = (int(rng.integers(0, 256)) if rng.random() < 0.5
                 else common[int(rng.integers(0, 3))])
            # every 3-gram that c makes, with the run planted after it
            w = out[-2:] + [c] + planted(len(out) + 1)[:2]
            if c == x or any(tuple(w[i:i + 3]) in seen
                             for i in range(len(w) - 2)):
                continue
            run = [c]
        for c in run:
            out.append(c)
            if len(out) >= 3:
                seen.add(tuple(out[-3:]))
    return bytes(out)


def sweep_input(name: str, level: int, shard_len: int, batch: int) -> bytes:
    """A sweep case's input: chip_smoke.py fuzz_mixed() (5,568 B: text,
    2,048 random bytes, text), the mixed corpus (20,000 B) or rfc1951 text
    (12,000 B), each cut to two batches and a third of a shard so a case
    stays a few batches, 5 KiB of zeros, 3 KiB of random bytes (every
    shard stored), 0, 1 or 100 bytes; "legacy" is the mixed corpus the
    level-sweep at 4096 / 512 / 2 always used (5 shards less 77 bytes,
    seeded by the level); "squeeze_flip" is squeeze_flip()."""
    cap = 2 * shard_len * batch + shard_len // 3
    if name == "fuzz_mixed":
        from chip_smoke import fuzz_mixed
        return fuzz_mixed()
    if name == "mixed":
        return corpus("mixed", min(20_000, cap), seed=17)
    if name == "text":
        return corpus("text", min(12_000, cap), seed=17)
    if name == "legacy":
        return corpus("mixed", 5 * S - 77, seed=level)
    if name == "squeeze_flip":
        return squeeze_flip()
    return {"zeros": bytes(5 << 10),
            "random": corpus("random", 3 << 10, seed=17),
            "empty": b"", "one": b"\x07",
            "hundred": corpus("text", 100, seed=18)}[name]


# (level, shard_len, ctx, batch, container, input): the port's own seed
# members of chip_smoke.py phase 17 (own_member)
OWN_SHAPES = tuple((6, 2048, 1024, 2, c, "fuzz_mixed") for c in CONTAINERS)

# sha256 of flate_tpu.jx.pipeline2.compress_device2(interpret=True) on
# these cases (tests/test_torch_shapes.py computes them): the own members,
# ctx above the shard (8192 / 7168 at levels 1 and 6, 32768 / 2048), a
# shard_len that is no power of two (7168), and a squeeze whose rounded code
# lengths decide the bytes (squeeze_flip)
PINNED = {
    (6, 2048, 1024, 2, "RAW", "fuzz_mixed"):
        "21301af851e2d6deabe80a6a99c50d91696afc0d73c42292b848e938aed97357",
    (6, 2048, 1024, 2, "ZLIB", "fuzz_mixed"):
        "6bc0ae08abf2105f3044e9a99fb26b4a1de94eafad30fd233b50585b1e1cf95b",
    (6, 2048, 1024, 2, "GZIP", "fuzz_mixed"):
        "08fa335f877d47ddc477386cc96c4695965697223f479ff2a24e0aa3cf740b57",
    (1, 7168, 8192, 2, "GZIP", "mixed"):
        "cebb0ecacce6273fc8a378943f31fe872452cb3be01ccd2ae57b2c500db9056e",
    (6, 7168, 8192, 2, "RAW", "mixed"):
        "ef25ecec4e07b00959eb98977e56103374bb8028196dad67af80b300f0fca44b",
    (1, 2048, 32768, 1, "GZIP", "text"):
        "134810fd4dc680a71dd74797926ad5adc7e481f67904bf27958d069365f7414b",
    (6, 32768, 1024, 1, "RAW", "squeeze_flip"):
        "2f416ed5d19b6e0f696a94d8a4fde615b12961fea6c9f330fe75f79e1abc4d90",
}


def sweep_cases(n: int = 60, seed: int = 17) -> list:
    """The shape sweep: OWN_SHAPES, then n - 3 combinations of the grid
    (SWEEP_SHARDS x SWEEP_CTX x SWEEP_BATCH x levels 1-9 x CONTAINERS, an
    input of SWEEP_INPUTS beside each) drawn with a seeded generator so
    that every value of every axis comes up about equally often (each
    axis a shuffled run of its values), then the other PINNED cases and
    the level sweep at 4096 / 512 / 2 on the "legacy" input.  Each case is
    (level, shard_len, ctx, batch, container, input)."""
    rng = np.random.default_rng(seed)
    k = n - len(OWN_SHAPES)
    cols = []
    for axis in (SWEEP_LEVELS, SWEEP_SHARDS, SWEEP_CTX, SWEEP_BATCH,
                 CONTAINERS, SWEEP_INPUTS):
        idx = np.resize(np.arange(len(axis)), k)
        rng.shuffle(idx)
        cols.append([axis[int(i)] for i in idx])
    drawn = [tuple(c) for c in zip(*cols)]
    pinned = [c for c in PINNED if c not in OWN_SHAPES]
    legacy = [(lv, S, CTX, 2, "GZIP", "legacy") for lv in SWEEP_LEVELS]
    return list(OWN_SHAPES) + drawn + pinned + legacy


def sweep_id(case) -> str:
    level, shard_len, ctx, batch, container, name = case
    return f"l{level}-s{shard_len}-c{ctx}-b{batch}-{container}-{name}"


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def stream_encode(case, data: bytes, device) -> bytes:
    """`data` through the container's streaming compressor at the case's
    shape on `device`: the first half written, a flush, the rest, the
    finish."""
    import io
    from flate_tpu_torch import api
    level, shard_len, ctx, batch, container, _ = case
    ns = getattr(api, {"RAW": "flate", "ZLIB": "zlib", "GZIP": "gzip"}[
        container])
    out = io.BytesIO()
    c = ns.compressor(out, level, shard_len=shard_len, ctx=ctx, batch=batch,
                      device=device)
    half = len(data) // 2
    c.write(data[:half])
    c.flush()
    c.write(data[half:])
    c.finish()
    return out.getvalue()
