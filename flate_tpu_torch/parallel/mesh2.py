"""Data-parallel single-program compression over a torch.distributed mesh.

Counterpart of flate_tpu/parallel/mesh2.py: _mesh_encode_fn's body (:66)
and compress_mesh2 (:114).  Every 128 KiB shard is an independent deflate
unit ending in a sync marker, so the only traffic between ranks inside a
batch is the context tail a rank's first shard borrows from the rank
before it.  Each batch of world x per_device shards is cut into per-rank
rows; rank r uploads only its own, receives rank r-1's last local shard
tail (the JAX package's ppermute: a send/recv pair on the rank's device,
outside the graph), and runs its body -- context priming, encode_core,
the rows' CRC32 / Adler32 and its own compaction -- as one CUDA graph on
the card (eagerly on the CPU).  The ranks then gather their meta and
their compacted bytes in rank order; every rank splices the same member,
with the FLT1 index and the checksum combined on the host.

Every rank calls compress_mesh2 with the same data, as every JAX process
calls the JAX function.  The stream is bit-identical to
device/pipeline2.compress_device2's at batch = world x per_device and the
same (level, shard_len, ctx).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import _build, consts
from ..containers import Container, Hasher
from ..device import graphs, pipeline2
from ..device import squeeze as sq
from .pigz import (_exchange_tail, _mesh_device, combined_crc32,  # noqa: F401
                   make_mesh)

CTX = consts.MAX_DISTANCE


def _body(shards, first, ctx_lens, valid, finals, nb, *, hash_kind: int,
          **kn):
    """A rank's rows (Bl, S) and its first row's context `first` (ctx,)
    -> (buf, meta_out) of its own compaction: [total | blens | hash
    words], rows past the batch's nb dead."""
    windows = pipeline2._prime_windows(shards, first, kn["ctx"])
    words, tbits, _ = pipeline2.encode_core(windows, ctx_lens, valid,
                                            finals, **kn)
    return pipeline2._compact_stage(words, tbits, shards, valid, nb,
                                    hash_kind=hash_kind)


def compress_mesh2(data: bytes, mesh: DeviceMesh | None = None,
                   level: int = consts.LEVEL_DEFAULT,
                   container: Container = Container.GZIP,
                   shard_len: int = consts.SHARD_LEN,
                   ctx: int = CTX, per_device: int = 4,
                   axis: str = "shards", index: bool = True,
                   return_lens: bool = False):
    """One-shot compress, data-parallel over the mesh's ranks.

    Returns the member, or with return_lens (member, per-shard compressed
    lengths, header length, footer length).  The next batch is dispatched
    before the current one is gathered.  ctx must not exceed shard_len:
    a rank's first shard takes its context from one shard before it."""
    kern = pipeline2.level_params(level, shard_len)
    if ctx > shard_len:
        raise ValueError(f"ctx {ctx} exceeds shard_len {shard_len}")
    mesh = mesh if mesh is not None else make_mesh(axis=axis)
    group = mesh.get_group(axis)
    world = mesh.size()
    rank = mesh.get_local_rank(axis)
    dev = _mesh_device(mesh)
    pin = dev.type == "cuda"
    Bl = per_device
    batch = world * Bl
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    S = shard_len
    nshards = max(1, -(-n // S))
    hash_kind = {Container.GZIP: pipeline2.HASH_CRC32,
                 Container.ZLIB: pipeline2.HASH_ADLER32}.get(
                     container, pipeline2.HASH_NONE)
    kn = dict(S=S, ctx=ctx, **kern)
    body = functools.partial(_body, hash_kind=hash_kind, **kn)
    key = ("mesh2", dev, Bl, tuple(sorted(kn.items())), hash_kind,
           sq.hist_stride_default())

    def dispatch(base_shard: int):
        nb = min(batch, nshards - base_shard)
        lo0 = base_shard * S
        g0 = base_shard + rank * Bl            # this rank's first shard
        host = torch.zeros(Bl * S + ctx, dtype=torch.uint8, pin_memory=pin)
        small = torch.zeros(3 * Bl + 1, dtype=torch.int32, pin_memory=pin)
        hb, sm = host.numpy(), small.numpy()
        lo = g0 * S
        hi = min(n, lo + Bl * S)
        if hi > lo:
            hb[:hi - lo] = arr[lo:hi]
        c0 = min(ctx, lo0)
        if rank == 0 and c0:
            hb[Bl * S + ctx - c0:] = arr[lo0 - c0:lo0]
        rows = np.arange(Bl) + rank * Bl       # global rows of the batch
        sm[:Bl] = np.where(rows == 0, c0, ctx)
        live = rows < nb
        sm[Bl:2 * Bl] = np.where(
            live, np.minimum(S, n - (base_shard + rows) * S), 0)
        if base_shard + nb == nshards:
            sm[2 * Bl:3 * Bl] = rows == nb - 1
        sm[3 * Bl] = int(live.sum())
        hd = host.to(dev, non_blocking=True)
        sd = small.to(dev, non_blocking=True)
        shards = hd[:Bl * S].view(Bl, S)
        first = _exchange_tail(shards, hd[Bl * S:], ctx, rank, world, group)
        inputs = (shards, first, sd[:Bl], sd[Bl:2 * Bl], sd[2 * Bl:3 * Bl],
                  sd[3 * Bl:])
        if _build.use_plain(shards):
            buf, meta_out = body(*inputs)
        else:
            buf, meta_out = graphs.cached(key, body, inputs)(*inputs)
        valid = np.minimum(S, n - (base_shard + np.arange(nb)) * S)
        return nb, buf, meta_out, np.maximum(valid, 0)

    out = bytearray()
    comp_lens: list = []
    hasher = Hasher(container)
    fetchers = [pipeline2._ByteFetcher() for _ in range(world)]
    bases = list(range(0, nshards, batch))
    inflight = dispatch(bases[0])
    for j in range(len(bases)):
        nb, buf, meta_out, valid = inflight
        if j + 1 < len(bases):
            inflight = dispatch(bases[j + 1])
        metas, bufs = _gather(buf, meta_out, world, group)
        hashes = [[], []]
        for r in range(world):
            live = min(Bl, nb - r * Bl)
            if live <= 0:
                break
            m = metas[r]
            out += fetchers[r](bufs[r], int(m[0])).tobytes()
            comp_lens.extend(int(x) for x in m[1:1 + live])
            hashes[0].append(m[1 + Bl:1 + Bl + live])
            hashes[1].append(m[1 + 2 * Bl:1 + 2 * Bl + live])
        if hash_kind != pipeline2.HASH_NONE:
            pipeline2._fold_hashes(hasher, hash_kind,
                                   np.concatenate(hashes[0]),
                                   np.concatenate(hashes[1]), valid, S)

    header, footer = pipeline2._container_parts(
        container, index, False, nshards, S, n, comp_lens, hasher)
    blob = header + bytes(out) + footer
    if return_lens:
        return blob, comp_lens, len(header), len(footer)
    return blob


def _gather(buf: torch.Tensor, meta_out: torch.Tensor, world: int, group):
    """Every rank's meta (host numpy) and compacted bytes (on the device,
    cut to a common width), in rank order."""
    metas = [torch.empty_like(meta_out) for _ in range(world)]
    dist.all_gather(metas, meta_out, group=group)
    metas = [m.cpu().numpy() for m in metas]
    width = max(1, max(int(m[0]) for m in metas))
    mine = buf[:width].contiguous()
    bufs = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(bufs, mine, group=group)
    return metas, bufs
