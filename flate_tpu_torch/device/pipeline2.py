"""Device-resident compression pipeline (one-shot encode).

Counterpart of flate_tpu/jx/pipeline2.py: LEVEL_KERNEL, _nwr,
_prime_windows (:120), _squeeze_stage (:157), encode_batch_packed (:261),
_compact_stage (:223), compress_device2 / _compress_device2_impl (:338)
and _assemble (:593).  Per batch of B shards of S bytes:

    windows -> matcher -> parse -> [squeeze cost DP] -> field build ->
    bit-pack -> compaction

The host moves bytes: it uploads a batch, fetches its compacted stream
and a small meta array, and wraps the container.  Batches are dispatched
two ahead on one CUDA stream; the 32 KiB context is carried on the device
from batch to batch.  Levels 1-9; levels 2 and 4-9 run the squeeze.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import consts, shard_index
from ..checksums import adler32_combine, crc32_combine
from ..containers import (Container, GzipMetadata, Hasher, write_footer,
                          write_header)
from . import checksum, encode2, match2, resolve_device
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
    byts = words.reshape(B, -1).view(torch.uint8)   # little-endian words
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


def encode_batch_packed(shards: torch.Tensor, ctx0: torch.Tensor,
                        meta_in: torch.Tensor, *, S: int, ctx: int, K: int,
                        nw: int, lazy: bool, max_lazy: int, K3: int = 0,
                        squeeze: bool = False, blk: int = prs.PARSE_BLK,
                        hash_kind: int = HASH_NONE):
    """One batch through the whole encode.  shards (B, S) uint8, ctx0
    (ctx,) uint8, meta_in (3B+1,) int32 = [ctx_lens | valid | finals |
    nb], all on the device.  Returns _compact_stage's (buf, meta_out)."""
    B = shards.shape[0]
    ctx_lens, valid_lens = meta_in[:B], meta_in[B:2 * B]
    finals, nb = meta_in[2 * B:3 * B], meta_in[3 * B]
    windows = _prime_windows(shards, ctx0, ctx)
    mlen, mdist = match2.find_matches_fused(
        windows, ctx_lens, valid_lens, K=K, nw=nw, ctx=ctx, K3=K3)
    mlen, mdist = prs.truncate_matches(mlen, mdist, ctx, blk)
    take, _ = prs.decide(mlen, mdist, lazy, max_lazy)
    starts = prs.parse_blocks(mlen, mdist, start=ctx, lazy=lazy,
                              max_lazy=max_lazy, blk=blk)
    m_r, d_r = mlen[:, ctx:], mdist[:, ctx:]
    take_r, starts_r = take[:, ctx:], starts[:, ctx:]
    if squeeze:
        take_r, starts_r, m_r = _squeeze_stage(
            windows[:, ctx:], m_r, d_r, take_r, starts_r, valid_lens,
            blk=blk)
    seg = encode2.seg_size(S, blk)
    vals, bits, _, _ = encode2.build_fields(
        windows[:, ctx:], m_r, d_r, starts_r, take_r, valid_lens, finals,
        S, seg)
    words, tbits = pk.pack_fields(vals, bits, _nwr(S, seg))
    return _compact_stage(words, tbits, shards, valid_lens, nb,
                          hash_kind=hash_kind)


def compress_device2(data: bytes, level: int = consts.LEVEL_DEFAULT,
                     container: Container = Container.GZIP,
                     shard_len: int = consts.SHARD_LEN,
                     ctx: int = CTX, batch: int = 64,
                     index: bool = True,
                     independent: bool = False,
                     device: str | torch.device = "cuda") -> bytes:
    """One-shot compress through the device pipeline.

    With `index` (gzip only) the header carries an FLT1 EXTRA subfield
    with per-shard (compressed, output) byte lengths; standard gzip tools
    ignore it.  `independent` drops the cross-shard context priming
    (flagged in the index) so every shard decodes on its own."""
    kern = level_params(level, shard_len)
    dev = resolve_device(device)
    return _compress_device2_impl(data, kern, container, shard_len, ctx,
                                  batch, index, independent, dev)


def _compress_device2_impl(data, kern, container, shard_len, ctx, batch,
                           index, independent, dev) -> bytes:
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
        if hash_kind == HASH_CRC32:
            crcs = checksum.crc32_fixup(meta_np[1 + batch:1 + batch + nb],
                                        valid, checksum.padded_width(S))
            for i in range(nb):
                ln = int(valid[i])
                if ln:
                    hasher.value = crc32_combine(hasher.value, int(crcs[i]),
                                                 ln)
                hasher.nbytes += ln
        else:
            adl = checksum.adler_finalize(
                meta_np[1 + batch:1 + batch + nb],
                meta_np[1 + 2 * batch:1 + 2 * batch + nb], valid)
            for i in range(nb):
                ln = int(valid[i])
                if ln:
                    hasher.value = adler32_combine(hasher.value,
                                                   int(adl[i]), ln)
                hasher.nbytes += ln

    return _assemble(container, index, independent, nshards, S, n,
                     comp_lens, out, hasher)


def _assemble(container, index, independent, nshards, S, n, comp_lens,
              out, hasher) -> bytes:
    if index and container is Container.GZIP \
            and nshards <= shard_index.MAX_SHARDS:
        out_lens = [min(S, n - i * S) if n else 0 for i in range(nshards)]
        flags = shard_index.FLAG_INDEPENDENT if independent else 0
        meta = GzipMetadata(
            extra=shard_index.build_index_extra(comp_lens, out_lens, flags))
        header = write_header(container, meta)
    else:
        header = write_header(container)
    return header + bytes(out) + write_footer(container, hasher)
