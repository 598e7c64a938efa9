"""Rank body of tests/test_torch_mesh2.py: one process of a gloo group on
the CPU, joined over a FileStore, that runs the mesh encoder's cases and
pickles what each returned for the test process to compare.  No JAX: the
ranks import only the port."""

from __future__ import annotations

import datetime
import pathlib
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from _torch_corpora import corpus
from flate_tpu_torch.containers import Container
from flate_tpu_torch.parallel import distributed
from flate_tpu_torch.parallel.mesh2 import compress_mesh2

S = 2048
CTX = 1024
PER_DEVICE = 2


def cases(world: int) -> dict:
    """name -> (function, data, keyword arguments) of the mesh cases."""
    text = corpus("text", 20 * S + 77, seed=world)       # 3+ batches
    mixed = corpus("mixed", 9 * S + 5, seed=world + 1)
    period = bytes(np.random.default_rng(11).integers(0, 256, CTX,
                                                      dtype=np.uint8))
    regions = (b"ownership 0123456789 abcdefgh " * 4000)[:48 * 1024]
    kw = dict(shard_len=S, ctx=CTX, per_device=PER_DEVICE)
    return {
        "text6": (compress_mesh2, text, dict(level=6, **kw)),
        "mixed1_zlib": (compress_mesh2, mixed,
                        dict(level=1, container=Container.ZLIB, **kw)),
        "mixed3_raw": (compress_mesh2, mixed,
                       dict(level=3, container=Container.RAW, **kw)),
        "period6": (compress_mesh2, period * (8 * S // CTX),
                    dict(level=6, **kw)),
        "regions_process": (distributed.compress_to_regions, regions,
                            dict(level=6, by="process", **kw)),
        "regions_device": (distributed.compress_to_regions, regions,
                           dict(level=6, by="device", **kw)),
        "lens": (compress_mesh2, regions,
                 dict(level=6, return_lens=True, **kw)),
    }


def run(rank: int, world: int, store_path: str, out_dir: str,
        scaling: bool) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shards",))
        res = {"initialize": distributed.initialize()}
        for name, (fn, data, kw) in cases(world).items():
            res[name] = fn(data, mesh, **kw)
        if scaling:
            res["scaling"] = distributed.scaling_efficiency(
                size_mb=1, level=1, shard_len=S)
        with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()
