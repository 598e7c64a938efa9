"""The mesh and the checksum combine of the data-parallel encoders.

Counterpart of flate_tpu/parallel/pigz.py: make_mesh (:31) and
combined_crc32 (:36).  compress_mesh (:45) runs on the JAX package's
round-1 pipeline, which the port does not have yet.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..checksums import crc32, crc32_combine


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
