"""Device-resident compression pipeline (one-shot and streaming encode).

Counterpart of flate_tpu/jx/pipeline2.py: LEVEL_KERNEL, _nwr, encode_core
(:66), encode_batch (:104), _prime_windows (:120), _parse_stage (:137),
_squeeze_stage (:157), encode_batch_staged (:169), _words_to_bytes (:203),
_split_meta (:216), _compact_stage (:223), encode_batch_packed (:261),
_ByteFetcher (:297), _Fetcher (:316), compress_device2 /
_compress_device2_impl (:338), DeviceEncoder (:506), _assemble (:593) and
_compress_fused_loop (:607).  Per batch of B shards of S bytes:

    windows -> matcher -> parse -> [squeeze cost DP] -> field build ->
    bit-pack -> compaction

The host moves bytes: it uploads a batch, fetches its compacted stream
and a small meta array, and wraps the container.  compress_device2
dispatches batches two ahead on one CUDA stream; the 32 KiB context is
carried on the device from batch to batch.  With fused=True it runs
encode_batch instead, which on the card replays one CUDA graph a batch
(device/graphs.py: captured once per shape and level knobs), the
counterpart of the JAX package's one jitted program a batch, and fetches
the used rows of the word grid.  DeviceEncoder encodes a stream call by
call, one batch at a time.  Levels 1-9; levels 2 and 4-9 run the squeeze.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build, consts, metrics, shard_index
from ..checksums import adler32_combine, crc32_combine
from ..containers import (Container, GzipMetadata, Hasher, write_footer,
                          write_header)
from . import checksum, encode2, graphs, match2, resolve_device
from . import pack as pk
from . import parse as prs
from . import squeeze as sq

CTX = consts.MAX_DISTANCE
PACK_WIN = 640                   # the packer's placement window (words)

# level knobs: (K candidates, carried words, lazy, max_lazy, K3 3-byte
# cands, squeeze, parse-block size) — the JAX package's table, value for
# value
LEVEL_KERNEL = {
    1: (4, 2, False, 0, 0, False, 1024),
    2: (8, 2, False, 0, 0, True, 1024),
    3: (12, 4, False, 0, 0, False, 1024),
    4: (16, 4, True, 4, 0, True, 1024),
    5: (24, 8, True, 16, 0, True, 1024),
    6: (48, 8, True, 32, 0, True, 1024),
    7: (64, 16, True, 64, 8, True, 4096),
    8: (96, 16, True, 128, 12, True, 4096),
    9: (160, 16, True, 258, 16, True, 4096),
}

HASH_NONE, HASH_CRC32, HASH_ADLER32 = 0, 1, 2


def level_params(level: int, shard_len: int = consts.SHARD_LEN) -> dict:
    """Kernel knobs of a level, with the parse block fitted to the shard.
    Raises ValueError for an unknown level."""
    if level not in LEVEL_KERNEL:
        raise ValueError(f"invalid level {level}")
    K, nw, lazy, max_lazy, K3, squeeze, blk = LEVEL_KERNEL[level]
    blk = min(blk, shard_len)
    while shard_len % blk:
        blk //= 2
    return dict(K=K, nw=nw, lazy=lazy, max_lazy=max_lazy, K3=K3,
                squeeze=squeeze, blk=blk)


def _nwr(S: int, seg: int) -> int:
    """Word rows (of 128) that bound a shard stream: the kind argmin never
    exceeds the all-stored cost (44 bits per merged stored header incl.
    pad) + the trailer block, plus the packer's placement window."""
    nseg = -(-S // seg)
    worst_bits = 8 * S + 44 * (nseg + 2) + 256
    return -(-worst_bits // (32 * 128)) + PACK_WIN // 128


def _prime_windows(shards: torch.Tensor, ctx0: torch.Tensor,
                   ctx: int) -> torch.Tensor:
    """(B, S) + (ctx,) carry -> (B, ctx+S) windows: row b's context is the
    last `ctx` bytes of [carry | rows 0..b-1] (ctx may exceed S)."""
    B, S = shards.shape
    kc = -(-ctx // S)
    pad = kc * S - ctx
    c0 = torch.nn.functional.pad(ctx0, (pad, 0)) if pad else ctx0
    ext = torch.cat([c0.reshape(kc, S), shards], dim=0)
    parts = [ext[j:j + B] for j in range(kc)] + [shards]
    return torch.cat(parts, dim=1)[:, pad:].contiguous()


def _parse_stage(mlen: torch.Tensor, mdist: torch.Tensor, *, lazy: bool,
                 max_lazy: int, ctx: int, blk: int = prs.PARSE_BLK):
    """Truncate matches to parse blocks, decide, walk.  Returns (take,
    starts, mlen, mdist) with the truncated matches: the field build must
    use them so the emitted tokens agree with the walk."""
    mlen, mdist = prs.truncate_matches(mlen, mdist, ctx, blk)
    take, _ = prs.decide(mlen, mdist, lazy, max_lazy)
    starts = prs.parse_blocks(mlen, mdist, start=ctx, lazy=lazy,
                              max_lazy=max_lazy, blk=blk)
    return take, starts, mlen, mdist


def _words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(B, nwr, 128) u32 LSB-first words (int32 bit patterns) -> (B,
    nwr*512) uint8 stream: the words' little-endian bytes."""
    return words.reshape(words.shape[0], -1).contiguous().view(torch.uint8)


def _split_meta(meta_in: torch.Tensor):
    """(3B+1,) [ctx_lens | valid | finals | nb] -> its four parts."""
    B = (meta_in.shape[0] - 1) // 3
    return (meta_in[:B], meta_in[B:2 * B], meta_in[2 * B:3 * B],
            meta_in[3 * B])


def _compact_stage(words: torch.Tensor, tbits: torch.Tensor,
                   shards: torch.Tensor, valid_lens: torch.Tensor,
                   nb: torch.Tensor, hash_kind: int = HASH_NONE):
    """(words, tbits) -> (buf, meta_out): splice the batch's shard streams
    in order on the device, so the host fetches exactly the compressed
    bytes plus one small array.  meta_out int64 = [total_bytes |
    byte_lens(B) | hash words]: raw per-row CRC32 over the padded width
    (HASH_CRC32, fixed up by checksum.crc32_fixup) or Adler s1 | s2
    (HASH_ADLER32)."""
    B = words.shape[0]
    dev = words.device
    live = torch.arange(B, device=dev) < nb
    blens = torch.where(live, tbits.to(torch.int64) // 8, 0)
    ends = torch.cumsum(blens, dim=0)
    offs = ends - blens
    byts = _words_to_bytes(words)
    L = byts.shape[1]
    j = torch.arange(B * L, dtype=torch.int64, device=dev)
    row = torch.clamp(torch.searchsorted(ends, j, right=True), max=B - 1)
    col = torch.clamp(j - offs[row], 0, L - 1)
    buf = byts[row, col]                # bytes past total are don't-care

    parts = [ends[-1:], blens]
    if hash_kind == HASH_CRC32:
        parts.append(checksum._crc32_rows_any(shards))
    elif hash_kind == HASH_ADLER32:
        parts.extend(checksum._adler_rows_any(shards, valid_lens))
    return buf, torch.cat(parts)


def _squeeze_stage(window_tail, m_r, d_r, take_r, starts_r, valid_lens,
                   blk: int = prs.PARSE_BLK, grid_only: bool | None = None,
                   hist_stride: int | None = None):
    """Greedy code lengths, then the cost DP: (take, starts, lengths) of
    the cheaper parse.  grid_only and hist_stride default to
    FLATE_TPU_SQUEEZE_GRID and FLATE_TPU_SQUEEZE_HIST_STRIDE, read when
    called."""
    if grid_only is None:
        grid_only = sq.grid_only_default()
    ll_bits, d_bits = sq.greedy_code_lengths(
        window_tail, m_r, d_r, starts_r, take_r, valid_lens,
        stride=hist_stride)
    take2, starts2, sel = sq.squeeze_parse(
        window_tail, m_r, d_r, ll_bits, d_bits, blk=blk, grid_only=grid_only)
    return take2, starts2, torch.where(take2, sel, 0)


def _encode_stages(windows, ctx_lens, valid_lens, finals, *, S: int,
                   ctx: int, K: int, nw: int, lazy: bool, max_lazy: int,
                   K3: int, squeeze: bool, blk: int,
                   grid_only: bool | None):
    mlen, mdist = match2.find_matches_fused(
        windows, ctx_lens, valid_lens, K=K, nw=nw, ctx=ctx, K3=K3)
    take, starts, mlen, mdist = _parse_stage(
        mlen, mdist, lazy=lazy, max_lazy=max_lazy, ctx=ctx, blk=blk)
    m_r, d_r = mlen[:, ctx:], mdist[:, ctx:]
    take_r, starts_r = take[:, ctx:], starts[:, ctx:]
    if squeeze:
        take_r, starts_r, m_r = _squeeze_stage(
            windows[:, ctx:], m_r, d_r, take_r, starts_r, valid_lens,
            blk=blk, grid_only=grid_only)
    seg = encode2.seg_size(S, blk)
    vals, bits, _, kind = encode2.build_fields(
        windows[:, ctx:], m_r, d_r, starts_r, take_r, valid_lens, finals,
        S, seg)
    words, tbits = pk.pack_fields(vals, bits, _nwr(S, seg))
    return words, tbits, kind


def encode_core(windows: torch.Tensor, ctx_lens: torch.Tensor,
                valid_lens: torch.Tensor, finals: torch.Tensor, *, S: int,
                ctx: int, K: int, nw: int, lazy: bool, max_lazy: int,
                K3: int = 0, squeeze: bool = False,
                blk: int = prs.PARSE_BLK):
    """(B, ctx+S) primed windows -> (words (B, nwr, 128) int32 u32 bit
    patterns, tbits (B,) int32, kind (B,) int64 block kind).

    The heart of the single-program encode, shared by encode_batch and
    the mesh encoder (parallel/mesh2.py, which primes the windows with a
    context exchange between ranks).  It never waits for the device and
    copies nothing from host memory, so a CUDA graph can capture it.  Its
    squeeze takes the full-length option whatever
    FLATE_TPU_SQUEEZE_GRID says, as the JAX program does."""
    return _encode_stages(windows, ctx_lens, valid_lens, finals, S=S,
                          ctx=ctx, K=K, nw=nw, lazy=lazy, max_lazy=max_lazy,
                          K3=K3, squeeze=squeeze, blk=blk, grid_only=False)


def _prime_and_encode(shards, ctx0, ctx_lens, valid_lens, finals, **kn):
    return encode_core(_prime_windows(shards, ctx0, kn["ctx"]), ctx_lens,
                       valid_lens, finals, **kn)


def encode_batch(shards: torch.Tensor, ctx0: torch.Tensor,
                 ctx_lens: torch.Tensor, valid_lens: torch.Tensor,
                 finals: torch.Tensor, *, S: int, ctx: int, K: int, nw: int,
                 lazy: bool, max_lazy: int, K3: int = 0,
                 squeeze: bool = False, blk: int = prs.PARSE_BLK):
    """shards (B, S) uint8 + ctx0 (ctx,) carry -> encode_core's (words,
    tbits, kind): context priming, then encode_core.

    On CPU tensors it runs eagerly.  On CUDA tensors it replays one CUDA
    graph, captured on the first call for this (device, shapes, knobs,
    FLATE_TPU_SQUEEZE_HIST_STRIDE) after a warm-up call on a side stream;
    the inputs are copied into the graph's own, and the outputs are
    copies that the next replay does not touch."""
    kn = dict(S=S, ctx=ctx, K=K, nw=nw, lazy=lazy, max_lazy=max_lazy,
              K3=K3, squeeze=squeeze, blk=blk)
    inputs = (shards, ctx0, ctx_lens, valid_lens, finals)
    if _build.use_plain(shards):
        return _prime_and_encode(*inputs, **kn)
    key = ("encode_batch", shards.device,
           tuple((tuple(x.shape), x.dtype) for x in inputs),
           tuple(sorted(kn.items())), sq.hist_stride_default())
    fn = functools.partial(_prime_and_encode, **kn)
    return graphs.cached(key, fn, inputs)(*inputs)


def encode_batch_staged(shards: torch.Tensor, ctx0: torch.Tensor,
                        ctx_lens: torch.Tensor, valid_lens: torch.Tensor,
                        finals: torch.Tensor, *, S: int, ctx: int, K: int,
                        nw: int, lazy: bool, max_lazy: int, K3: int = 0,
                        squeeze: bool = False, blk: int = prs.PARSE_BLK):
    """The eager twin of encode_batch: the same stages launched one by
    one, with the squeeze's FLATE_TPU_SQUEEZE_GRID read when called (the
    JAX staged path reads it too).  Returns (words, tbits, kind)."""
    windows = _prime_windows(shards, ctx0, ctx)
    return _encode_stages(windows, ctx_lens, valid_lens, finals, S=S,
                          ctx=ctx, K=K, nw=nw, lazy=lazy, max_lazy=max_lazy,
                          K3=K3, squeeze=squeeze, blk=blk, grid_only=None)


def encode_batch_packed(shards: torch.Tensor, ctx0: torch.Tensor,
                        meta_in: torch.Tensor, *, S: int, ctx: int, K: int,
                        nw: int, lazy: bool, max_lazy: int, K3: int = 0,
                        squeeze: bool = False, blk: int = prs.PARSE_BLK,
                        hash_kind: int = HASH_NONE):
    """One batch through the whole encode.  shards (B, S) uint8, ctx0
    (ctx,) uint8, meta_in (3B+1,) int32 = [ctx_lens | valid | finals |
    nb], all on the device.  Returns _compact_stage's (buf, meta_out)."""
    ctx_lens, valid_lens, finals, nb = _split_meta(meta_in)
    words, tbits, _ = encode_batch_staged(
        shards, ctx0, ctx_lens, valid_lens, finals, S=S, ctx=ctx, K=K,
        nw=nw, lazy=lazy, max_lazy=max_lazy, K3=K3, squeeze=squeeze,
        blk=blk)
    return _compact_stage(words, tbits, shards, valid_lens, nb,
                          hash_kind=hash_kind)


def _to_host(t: torch.Tensor, pinned: bool = False) -> torch.Tensor:
    """t on the host: a pinned copy enqueued without waiting (pinned, from
    a CUDA tensor; read it after the stream has passed the copy), a
    blocking copy, or t itself on the CPU."""
    if not t.is_cuda:
        return t
    if not pinned:
        return t.cpu()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


class _ByteFetcher:
    """Pow2-row granular fetch of a compacted byte buffer: rows of GR
    bytes, their count rounded up to a power of two, so the copies keep a
    small set of sizes."""

    GR = 1 << 17                  # 128 KiB rows

    def __call__(self, buf: torch.Tensor, total: int) -> np.ndarray:
        cap = buf.shape[0]
        rows_all = cap // self.GR
        rows = -(-max(total, 1) // self.GR)
        rows = min(1 << (rows - 1).bit_length(), rows_all)
        if total < cap and rows * self.GR >= total:
            buf = buf[:rows * self.GR]
        return _to_host(buf).numpy()[:total]


class _Fetcher:
    """Bucketed fetch of the used word-row prefix: the first guess_rows
    rows of every shard go to pinned host memory without waiting, then
    tbits is read; when the guess was short the rows needed follow.  The
    guess follows the last batch's need (a power of two)."""

    def __init__(self):
        self.guess_rows = 16

    def __call__(self, words: torch.Tensor, tbits_dev: torch.Tensor):
        nwr = words.shape[1]
        guess = min(self.guess_rows, nwr)
        wslice = _to_host(words[:, :guess], pinned=True)
        tbits = _to_host(tbits_dev).numpy()         # waits for both copies
        need = int(tbits.max()) if tbits.size else 0
        rows = -(-max(need, 1) // (32 * 128)) + 1
        rows = min(1 << (rows - 1).bit_length(), nwr)
        self.guess_rows = rows
        if rows <= guess:
            return wslice.numpy()[:, :rows], tbits
        return _to_host(words[:, :rows]).numpy(), tbits


def compress_device2(data: bytes, level: int = consts.LEVEL_DEFAULT,
                     container: Container = Container.GZIP,
                     shard_len: int = consts.SHARD_LEN,
                     ctx: int = CTX, batch: int = 64,
                     index: bool = True,
                     independent: bool = False,
                     device: str | torch.device = "cuda",
                     fused: bool = False) -> bytes:
    """One-shot compress through the device pipeline.

    With `index` (gzip only) the header carries an FLT1 EXTRA subfield
    with per-shard (compressed, output) byte lengths; standard gzip tools
    ignore it.  `independent` drops the cross-shard context priming
    (flagged in the index) so every shard decodes on its own.  `fused`
    runs each batch through encode_batch (one CUDA graph a batch on the
    card) and fetches the word grid: the same bytes."""
    kern = level_params(level, shard_len)
    dev = resolve_device(device)
    with metrics.timed("device.compress", len(data), level=level) as m:
        out = _compress_device2_impl(data, kern, container, shard_len, ctx,
                                     batch, index, independent, dev, fused)
        m["bytes_out"] = len(out)
    return out


def _fold_hashes(hasher: Hasher, hash_kind: int, a: np.ndarray,
                 b: np.ndarray | None, valid: np.ndarray, S: int) -> None:
    """Fold a batch's per-shard device hashes into the container hasher in
    stream order: raw CRC32s over the padded rows `a` (HASH_CRC32), or
    Adler s1 `a` and s2 `b` (HASH_ADLER32); valid = the shards' bytes."""
    if hash_kind == HASH_CRC32:
        vals = checksum.crc32_fixup(a, valid, checksum.padded_width(S))
        combine = crc32_combine
    else:
        vals = checksum.adler_finalize(a, b, valid)
        combine = adler32_combine
    for v, ln in zip(vals, valid):
        ln = int(ln)
        if ln:
            hasher.value = combine(hasher.value, int(v), ln)
        hasher.nbytes += ln


def _compress_device2_impl(data, kern, container, shard_len, ctx, batch,
                           index, independent, dev, fused) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    S = shard_len
    nshards = max(1, -(-n // S))

    out = bytearray()
    comp_lens: list = []
    hasher = Hasher(container)
    # CRC32/Adler32 run on the device per shard, sharing the upload, and
    # combine on the host: no host pass over the whole input
    hash_kind = {Container.GZIP: HASH_CRC32,
                 Container.ZLIB: HASH_ADLER32}.get(container, HASH_NONE)
    if fused:
        _compress_fused_loop(arr, n, S, nshards, kern, ctx, batch,
                             independent, hash_kind, dev, hasher, out,
                             comp_lens)
        return _assemble(container, index, independent, nshards, S, n,
                         comp_lens, out, hasher)

    zeros_ctx = torch.zeros(ctx, dtype=torch.uint8, device=dev)
    pin = dev.type == "cuda"
    # staging buffers reused round-robin: two uploads in flight plus the
    # one being filled
    staging = [torch.zeros((batch, S), dtype=torch.uint8, pin_memory=pin)
               for _ in range(3)]

    def dispatch(base_shard: int, ctx0_dev, sbuf_i: int):
        nb = min(batch, nshards - base_shard)
        lo0 = base_shard * S
        shards_np = staging[sbuf_i].numpy()
        take_n = max(0, min(n - lo0, batch * S))
        shards_np.reshape(-1)[:take_n] = arr[lo0:lo0 + take_n]
        shards_np.reshape(-1)[take_n:] = 0
        meta = np.zeros(3 * batch + 1, dtype=np.int32)
        if not independent:
            meta[:batch] = np.minimum(
                ctx, lo0 + np.arange(batch, dtype=np.int64) * S)
        v = meta[batch:2 * batch]
        for i in range(nb):
            v[i] = max(0, min(S, n - (base_shard + i) * S))
        if base_shard + nb == nshards:
            meta[2 * batch + nb - 1] = 1
        meta[3 * batch] = nb
        shards_dev = staging[sbuf_i].to(dev, non_blocking=True, copy=True)
        meta_dev = torch.from_numpy(meta).to(dev)
        buf, meta_out = encode_batch_packed(
            shards_dev, ctx0_dev, meta_dev, S=S, ctx=ctx,
            hash_kind=hash_kind, **kern)
        if independent:
            nxt_ctx = zeros_ctx
        else:
            # last ctx bytes of [carry | batch] (ctx may exceed S)
            kc = -(-ctx // S)
            rows = shards_dev[max(0, batch - kc):].reshape(-1)
            nxt_ctx = torch.cat([ctx0_dev, rows])[-ctx:]
        return nb, buf, meta_out, nxt_ctx

    bases = list(range(0, nshards, batch))
    # two batches in flight: the fetch of batch j overlaps the device
    # work of j+1
    DEPTH = 2
    queue = []
    ctx_dev = zeros_ctx
    for b in bases[:DEPTH]:
        item = dispatch(b, ctx_dev, len(queue) % len(staging))
        ctx_dev = item[3]
        queue.append(item)
    ndisp = min(DEPTH, len(bases))
    for j in range(len(bases)):
        nb, buf, meta_out, _ = queue.pop(0)
        if ndisp < len(bases):
            item = dispatch(bases[ndisp], ctx_dev, ndisp % len(staging))
            ctx_dev = item[3]
            queue.append(item)
            ndisp += 1
        meta_np = meta_out.cpu().numpy()
        total = int(meta_np[0])
        out += buf[:total].cpu().numpy().tobytes()
        comp_lens.extend(int(x) for x in meta_np[1:1 + nb])
        if hash_kind == HASH_NONE:
            continue
        valid = np.minimum(
            S, np.maximum(0, n - (bases[j] + np.arange(nb)) * S))
        _fold_hashes(hasher, hash_kind, meta_np[1 + batch:1 + batch + nb],
                     meta_np[1 + 2 * batch:1 + 2 * batch + nb], valid, S)

    return _assemble(container, index, independent, nshards, S, n,
                     comp_lens, out, hasher)


def _compress_fused_loop(arr, n, S, nshards, kern, ctx, batch, independent,
                         hash_kind, dev, hasher, out, comp_lens) -> None:
    """The word-grid fetch loop over encode_batch, the JAX package's
    fused twin of the staged loop: per batch the host builds the shards,
    the context carry ctx0 from the input and the small arrays, uploads
    them from pinned memory, and replays the batch's program; two batches
    stay in flight.  The shards' CRC32 / Adler32 run on the device beside
    it and fold into `hasher` in stream order; the shard streams are
    appended to `out` and their lengths to `comp_lens`."""
    pin = dev.type == "cuda"

    def dispatch(base_shard: int):
        nb = min(batch, nshards - base_shard)
        lo0 = base_shard * S
        # [shards | ctx0] bytes and [ctx_lens | valid | finals] words
        host = torch.zeros(batch * S + ctx, dtype=torch.uint8,
                           pin_memory=pin)
        small = torch.zeros(3 * batch, dtype=torch.int32, pin_memory=pin)
        hb, sm = host.numpy(), small.numpy()
        take_n = min(n - lo0, nb * S)
        hb[:take_n] = arr[lo0:lo0 + take_n]
        c0 = 0 if independent else min(ctx, lo0)
        if c0:
            hb[batch * S + ctx - c0:] = arr[lo0 - c0:lo0]
        if not independent:
            sm[:batch] = np.minimum(
                ctx, lo0 + np.arange(batch, dtype=np.int64) * S)
        valid = sm[batch:2 * batch]
        for i in range(nb):
            valid[i] = min(S, n - (base_shard + i) * S)
        if base_shard + nb == nshards:
            sm[2 * batch + nb - 1] = 1
        hd = host.to(dev, non_blocking=True)
        sd = small.to(dev, non_blocking=True)
        shards = hd[:batch * S].view(batch, S)
        valid_d = sd[batch:2 * batch]
        words, tbits, _ = encode_batch(
            shards, hd[batch * S:], sd[:batch], valid_d, sd[2 * batch:],
            S=S, ctx=ctx, **kern)
        hash_dev = ()
        if hash_kind == HASH_CRC32:
            hash_dev = (checksum._crc32_rows_any(shards),)
        elif hash_kind == HASH_ADLER32:
            hash_dev = checksum._adler_rows_any(shards, valid_d)
        return nb, words, tbits, hash_dev, valid.copy()

    fetch = _Fetcher()
    bases = list(range(0, nshards, batch))
    DEPTH = 2
    queue = [dispatch(b) for b in bases[:DEPTH]]
    for j in range(len(bases)):
        nb, words, tbits, hash_dev, valid = queue.pop(0)
        if j + DEPTH < len(bases):
            queue.append(dispatch(bases[j + DEPTH]))
        words_np, tbits_np = fetch(words, tbits)
        flat = words_np.reshape(words_np.shape[0], -1)
        for i in range(nb):
            tb = int(tbits_np[i])
            if tb % 8:
                raise AssertionError("shard streams must be byte-aligned")
            comp_lens.append(tb // 8)
            out += flat[i].view(np.uint8)[:tb // 8].tobytes()
        if hash_kind != HASH_NONE:
            h = [_to_host(x).numpy()[:nb] for x in hash_dev]
            _fold_hashes(hasher, hash_kind, h[0], h[-1], valid[:nb], S)


class DeviceEncoder:
    """Stateful streaming device encoder producing raw DEFLATE bytes.

    `encode(data, final=False)` encodes `data` completely, its tail shard
    padded, and returns the spliced shard streams.  Every shard stream ends
    with the empty stored block that byte-aligns it (encode2's trailer), so
    each call's output extends a decodable prefix: the flush contract of
    the streaming Compressor (api.py).  Inside a call the context is
    carried on the device from batch to batch; across calls it is rebuilt
    from the host history tail `_tail` (the device carry pads the tail
    shard with zeros), which a preset dictionary primes.  `comp_lens` and
    `out_lens` grow by each shard's compressed and input byte lengths."""

    def __init__(self, level: int = consts.LEVEL_DEFAULT,
                 shard_len: int = consts.SHARD_LEN, ctx: int = CTX,
                 batch: int = 64, dictionary: bytes | None = None,
                 device: str | torch.device = "cuda"):
        self._kern = level_params(level, shard_len)
        self.dev = resolve_device(device)
        self.S, self.ctx, self.batch = shard_len, ctx, batch
        self._tail = bytearray((dictionary or b"")[-ctx:])
        self._finished = False
        self.comp_lens: list = []
        self.out_lens: list = []

    def encode(self, data: bytes, final: bool = False) -> bytes:
        """Encode `data` and return its deflate bytes; final=True closes
        the stream (an empty final call is one empty shard)."""
        if self._finished:
            raise ValueError("encode after the final call")
        self._finished = final
        arr = np.frombuffer(data, dtype=np.uint8)
        n, S, batch, ctx = arr.size, self.S, self.batch, self.ctx
        nshards = -(-n // S)
        if final and nshards == 0:
            nshards = 1
        hist = len(self._tail)
        ctx0 = np.zeros(ctx, dtype=np.uint8)
        if hist:
            ctx0[ctx - hist:] = np.frombuffer(self._tail, dtype=np.uint8)
        ctx_dev = torch.from_numpy(ctx0).to(self.dev)
        kc = -(-ctx // S)
        pieces = []
        for base in range(0, nshards, batch):
            nb = min(batch, nshards - base)
            lo0 = base * S
            shards_np = np.zeros((batch, S), dtype=np.uint8)
            take_n = max(0, min(n - lo0, batch * S))
            shards_np.reshape(-1)[:take_n] = arr[lo0:lo0 + take_n]
            meta = np.zeros(3 * batch + 1, dtype=np.int32)
            meta[:batch] = np.minimum(
                ctx, hist + lo0 + np.arange(batch, dtype=np.int64) * S)
            v = meta[batch:2 * batch]
            for i in range(nb):
                v[i] = max(0, min(S, n - (base + i) * S))
            if final and base + nb == nshards:
                meta[2 * batch + nb - 1] = 1
            meta[3 * batch] = nb
            shards_dev = torch.from_numpy(shards_np).to(self.dev)
            buf, meta_out = encode_batch_packed(
                shards_dev, ctx_dev, torch.from_numpy(meta).to(self.dev),
                S=S, ctx=ctx, hash_kind=HASH_NONE, **self._kern)
            # last ctx bytes of [carry | batch], padding rows included
            rows = shards_dev[max(0, batch - kc):].reshape(-1)
            ctx_dev = torch.cat([ctx_dev, rows])[-ctx:]
            meta_np = meta_out.cpu().numpy()
            pieces.append(buf[:int(meta_np[0])].cpu().numpy().tobytes())
            self.comp_lens.extend(int(x) for x in meta_np[1:1 + nb])
            self.out_lens.extend(int(v[i]) for i in range(nb))
        if n >= ctx:
            self._tail = bytearray(bytes(data[-ctx:]))
        else:
            self._tail = (self._tail + bytes(data))[-ctx:]
        return b"".join(pieces)


def _container_parts(container, index, independent, nshards, S, n,
                     comp_lens, hasher) -> tuple[bytes, bytes]:
    """(header, footer) of a member: the FLT1 index in a gzip header with
    `index` and at most MAX_SHARDS shards, the checksum in the footer."""
    if index and container is Container.GZIP \
            and nshards <= shard_index.MAX_SHARDS:
        out_lens = [min(S, n - i * S) if n else 0 for i in range(nshards)]
        flags = shard_index.FLAG_INDEPENDENT if independent else 0
        meta = GzipMetadata(
            extra=shard_index.build_index_extra(comp_lens, out_lens, flags))
        header = write_header(container, meta)
    else:
        header = write_header(container)
    return header, write_footer(container, hasher)


def _assemble(container, index, independent, nshards, S, n, comp_lens,
              out, hasher) -> bytes:
    header, footer = _container_parts(container, index, independent,
                                      nshards, S, n, comp_lens, hasher)
    return header + bytes(out) + footer
