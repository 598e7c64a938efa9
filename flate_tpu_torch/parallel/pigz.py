"""pigz-style data-parallel compression over a torch.distributed mesh.

Counterpart of flate_tpu/parallel/pigz.py: make_mesh (:31), combined_crc32
(:36) and compress_mesh (:45), the round-1 pipeline (device/pipeline.py)
laid over the ranks.  Each 128 KiB shard is an independent deflate unit
ending in a sync flush, so each step gives every rank one shard:

  * rank r's context is the last ctx bytes of rank r-1's shard, sent and
    received on the ranks' devices (the JAX package's collective permute
    in build_windows); rank 0 takes its context from the input;
  * each rank runs phase1, plans its own shard on the host and packs it
    (phase2);
  * the ranks gather every shard's plan, bit count and used words in rank
    order, and every rank splices the same member;
  * CRC32 (over 4 MiB pieces, combined) or Adler32 for the footer.

Every rank calls compress_mesh with the same data.  The member equals
device/pipeline.compress_device's at batch = world and the same (level,
container, shard_len, ctx).  _exchange_tail and _mesh_device are shared
with mesh2.compress_mesh2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import block, consts
from ..bitpack import BitSink
from ..checksums import adler32, crc32, crc32_combine
from ..containers import Container, Hasher, write_footer, write_header
from ..device import pipeline as pl

CTX = consts.MAX_DISTANCE
PLAN_KINDS = ("dynamic", "fixed", "stored", "literal")


def make_mesh(device_type: str | None = None,
              axis: str = "shards") -> DeviceMesh:
    """A 1-D DeviceMesh named `axis` over the default process group, one
    rank a device (parallel.distributed.initialize, or
    torch.distributed.init_process_group, makes the group).  device_type
    None takes the group's: "cuda" for NCCL, "cpu" otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "parallel.distributed.initialize() or "
                           "torch.distributed.init_process_group first")
    if device_type is None:
        device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def combined_crc32(shard_bytes: list[bytes]) -> int:
    """CRC32 of the concatenation from per-shard CRCs and the GF(2)
    combine: the associative reduction a group of ranks computes."""
    crc = 0
    for s in shard_bytes:
        crc = crc32_combine(crc, crc32(s), len(s))
    return crc & 0xFFFFFFFF


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _exchange_tail(shards: torch.Tensor, ctx0: torch.Tensor, ctx: int,
                   rank: int, world: int, group) -> torch.Tensor:
    """The context of this rank's first row: the host carry ctx0 on rank
    0, the last ctx bytes of rank r-1's last row on rank r > 0 (sent
    and received on the rank's device)."""
    reqs = []
    if rank + 1 < world:
        tail = shards[-1, shards.shape[1] - ctx:].contiguous()
        reqs.append(dist.isend(tail, dist.get_global_rank(group, rank + 1),
                               group=group))
    first = ctx0
    if rank > 0:
        first = torch.empty_like(ctx0)
        reqs.append(dist.irecv(first, dist.get_global_rank(group, rank - 1),
                               group=group))
    for req in reqs:
        req.wait()
    return first


def _all_gather(t: torch.Tensor, world: int, group) -> list[np.ndarray]:
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t, group=group)
    return [p.cpu().numpy() for p in parts]


def compress_mesh(data: bytes, mesh: DeviceMesh | None = None,
                  level: int = consts.LEVEL_DEFAULT,
                  container: Container = Container.GZIP,
                  shard_len: int = consts.SHARD_LEN,
                  ctx: int = CTX, axis: str = "shards") -> bytes:
    """One-shot compress, one shard a rank a step over the mesh's ranks
    (None: make_mesh over the default group).  ValueError for an unknown
    level or ctx > shard_len."""
    knobs = pl.level_knobs(level)
    if ctx > shard_len:
        raise ValueError(f"ctx {ctx} exceeds shard_len {shard_len}")
    mesh = mesh if mesh is not None else make_mesh(axis=axis)
    group = mesh.get_group(axis)
    world = mesh.size()
    rank = mesh.get_local_rank(axis)
    dev = _mesh_device(mesh)
    S = shard_len
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    nfull = n // S

    out = bytearray(write_header(container))
    sink = BitSink()
    hasher = Hasher(container)
    hasher.nbytes = n
    if container is Container.GZIP:
        hasher.value = combined_crc32(
            [data[i:i + (1 << 22)] for i in range(0, n, 1 << 22)])
    elif container is Container.ZLIB:
        hasher.value = adler32(data)

    for base in range(0, nfull, world):
        nb = min(world, nfull - base)
        lo0 = base * S
        shard = np.zeros(S, dtype=np.uint8)
        if rank < nb:
            shard[:] = arr[lo0 + rank * S:lo0 + (rank + 1) * S]
        c0 = min(ctx, lo0)
        ctx0 = np.zeros(ctx, dtype=np.uint8)
        if rank == 0:
            ctx0[ctx - c0:] = arr[lo0 - c0:lo0]
        shard_dev = torch.from_numpy(shard).to(dev)[None, :]
        first = _exchange_tail(shard_dev, torch.from_numpy(ctx0).to(dev),
                               ctx, rank, world, group)
        window = torch.cat([first[None, :], shard_dev], dim=1)
        ctx_len = torch.tensor([c0 if rank == 0 else ctx],
                               dtype=torch.int32, device=dev)
        tok, stats = pl.phase1(window, ctx_len, ctx=ctx, **knobs)
        hll, hdd, ntokens = pl.unpack_stats(stats.cpu().numpy())
        plan = pl.plan_shards(hll, hdd, [shard])[0]
        llp, dp = pl.code_tables([plan], 1)
        words, tbits = pl.phase2_bucketed(tok, llp, dp, int(ntokens[0]))

        # every shard's plan and bit count, then its used words, in rank
        # order
        lens = np.zeros(2 + consts.NUM_LITLEN + consts.NUM_DIST, np.int64)
        lens[0] = PLAN_KINDS.index(plan.kind)
        if plan.ll_lens is not None:
            lens[2:2 + consts.NUM_LITLEN] = plan.ll_lens
            lens[2 + consts.NUM_LITLEN:] = plan.d_lens
        meta = torch.from_numpy(lens).to(dev)
        meta[1] = tbits[0]
        metas = _all_gather(meta, world, group)
        all_tbits = np.array([m[1] for m in metas[:nb]])
        width = pl._used_words(all_tbits, 1 << 62)
        mine = torch.nn.functional.pad(words[:, :width],
                                       (0, max(0, width - words.shape[1])))
        all_words = _all_gather(mine, world, group)

        for i in range(nb):
            m = metas[i]
            kind = PLAN_KINDS[int(m[0])]
            p = pl._ShardPlan(kind)
            if kind in ("dynamic", "fixed"):
                p.ll_lens = m[2:2 + consts.NUM_LITLEN].astype(np.int32)
                p.d_lens = m[2 + consts.NUM_LITLEN:].astype(np.int32)
            final = (base + i == nfull - 1) and (n % S == 0)
            view = arr[(base + i) * S:(base + i + 1) * S]
            pl.emit_shard(sink, p, all_words[i][0].view(np.uint32),
                          int(m[1]), view, final)
            if not final:
                block.write_flush_marker(sink)

    pl.write_tail(sink, arr, nfull, S, level)
    sink.align_to_byte()
    out += sink.getvalue()
    out += write_footer(container, hasher)
    return bytes(out)
