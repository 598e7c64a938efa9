"""Seeded inputs shared by the PyTorch-port parity tests (tests/test_torch_*).

Small shapes (shards of 4096 bytes, 512 bytes of context, batches of 2) as
in tests/test_fast_smoke.py; every corpus is built with numpy from a seed
so the JAX package and the port see the same bytes.
"""

from __future__ import annotations

import pathlib

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
