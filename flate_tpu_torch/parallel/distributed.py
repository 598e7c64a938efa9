"""Several processes: joining them, per-rank file regions, scaling.

Counterpart of flate_tpu/parallel/distributed.py: initialize (:40),
compress_to_regions (:62) and scaling_efficiency (:111).

* `initialize()` joins the processes that torchrun started into one
  default process group (NCCL on cards, gloo on the CPU), from torchrun's
  environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK); in
  a single process it does nothing and returns 0.
* `compress_to_regions()` runs the mesh encoder and returns each owner's
  byte regions of the stream (owner = rank: one process a device), so
  each process can write its own shards' bytes into a shared file.
* `scaling_efficiency()` times the mesh encoder on a one-rank subgroup
  and on the whole group.

Two ranks on the CPU, each running compress_mesh2 on the same input:

    torchrun --nproc-per-node 2 --no-python python3 -c "from
    flate_tpu_torch.parallel import distributed as d, make_mesh; from
    flate_tpu_torch.parallel.mesh2 import compress_mesh2; d.initialize(
    device='cpu'); print(len(compress_mesh2(b'x' * 100000, make_mesh(),
    shard_len=4096, ctx=1024, per_device=2)))"
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import consts
from ..containers import Container
from .mesh2 import compress_mesh2, make_mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str = "cuda") -> int:
    """Join (or create) the default process group; returns this rank.

    Reads MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK when the arguments
    are omitted (LOCAL_RANK picks the card); a single process, with
    neither, is left alone and gets 0."""
    if dist.is_initialized():
        return dist.get_rank()
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    coordinator = coordinator or (f"{addr}:{port}" if addr and port
                                  else None)
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "0")
                                         or 0)
    process_id = process_id if process_id is not None else int(
        os.environ.get("RANK", "-1"))
    if not coordinator or num_processes <= 1:
        return 0
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return process_id


def compress_to_regions(data: bytes, mesh: DeviceMesh | None = None,
                        level: int = 6,
                        container: Container = Container.GZIP,
                        shard_len: int = consts.SHARD_LEN,
                        per_device: int = 4, by: str = "process", **kw):
    """Mesh-compress and return (stream, regions).

    regions[o] = the (file_offset, nbytes) spans owner o produced: shard s
    lives in batch row s % batch, which rank (s % batch) // per_device
    encoded.  One process holds one device, so by="process" and
    by="device" give the same owners, the ranks.  The header belongs to
    owner 0 and the footer to the last; adjacent spans of one owner are
    merged."""
    if by not in ("process", "device"):
        raise ValueError(f"by must be 'process' or 'device', got {by!r}")
    mesh = mesh if mesh is not None else make_mesh()
    blob, comp_lens, hdr_len, foot_len = compress_mesh2(
        data, mesh, level=level, container=container, shard_len=shard_len,
        per_device=per_device, return_lens=True, **kw)
    nowners = mesh.size()
    batch = nowners * per_device
    regions: list[list[tuple[int, int]]] = [[] for _ in range(nowners)]

    def add(o: int, off: int, ln: int) -> None:
        if ln <= 0:
            return
        if regions[o] and regions[o][-1][0] + regions[o][-1][1] == off:
            regions[o][-1] = (regions[o][-1][0], regions[o][-1][1] + ln)
        else:
            regions[o].append((off, ln))

    add(0, 0, hdr_len)
    off = hdr_len
    for s, cl in enumerate(comp_lens):
        add((s % batch) // per_device, off, cl)
        off += cl
    add(nowners - 1, off, foot_len)
    if off + foot_len != len(blob):
        raise AssertionError("regions do not tile the stream")
    return blob, regions


def scaling_efficiency(size_mb: int = 8, level: int = 6,
                       shard_len: int = 64 * 1024) -> dict:
    """Throughput of compress_mesh2 on rank 0 alone and on every rank of
    the default process group (make_mesh's mesh), called on every rank.

    Returns {"n_devices", "gbps_1", "gbps_n", "efficiency"} with
    efficiency = gbps_n / (n * gbps_1); gbps is input GB/s on the host
    clock, the second of two calls (the first captures the graphs)."""
    mesh_n = make_mesh()
    n = mesh_n.size()
    text = b"scaling measurement corpus " * 1024
    data = (text * (size_mb * 1024 * 1024 // len(text) + 1))
    data = data[: size_mb * 1024 * 1024]
    ctx = min(consts.MAX_DISTANCE, shard_len)

    def run(mesh):
        compress_mesh2(data, mesh, level=level, shard_len=shard_len, ctx=ctx)
        t0 = time.perf_counter()
        compress_mesh2(data, mesh, level=level, shard_len=shard_len, ctx=ctx)
        return len(data) / (time.perf_counter() - t0) / 1e9

    if n == 1:
        g1 = gn = run(mesh_n)
    else:
        sub = dist.new_group([0])                # every rank makes it
        got = [0.0]
        if dist.get_rank() == 0:
            got[0] = run(DeviceMesh.from_group(
                sub, mesh_n.device_type, mesh_dim_names=("shards",)))
        dist.broadcast_object_list(got, src=0)
        g1 = got[0]
        gn = run(mesh_n)
    return {"n_devices": n, "gbps_1": round(g1, 4), "gbps_n": round(gn, 4),
            "efficiency": round(gn / (n * g1), 3) if n > 1 else 1.0}
