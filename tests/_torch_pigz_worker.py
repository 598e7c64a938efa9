"""Rank body of tests/test_torch_pigz.py: one process of a gloo group on
the CPU, joined over a FileStore, that runs the round-1 mesh encoder's
cases and pickles each member for the test process to compare.  No JAX:
the ranks import only the port."""

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
from flate_tpu_torch.parallel.pigz import compress_mesh

S = 4096
CTX = 4096


def digits(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return bytes(48 + rng.integers(0, 10, n, dtype=np.uint8))


def cases(world: int) -> dict:
    """name -> (data, keyword arguments) of the mesh cases: several steps
    with a last partial one and a tail, an exact multiple of the step, one
    shard with idle ranks, a tail alone, empty input, stored shards."""
    return {
        "text6": (corpus("text", (2 * world + 1) * S + 777, seed=world),
                  dict(level=6)),
        "mixed1_zlib": (corpus("mixed", 2 * world * S, seed=world + 1),
                        dict(level=1, container=Container.ZLIB)),
        "digits9_raw": (digits(S + 300, seed=world),
                        dict(level=9, container=Container.RAW)),
        "short4": (corpus("mixed", 1000, seed=3), dict(level=4)),
        "empty3": (b"", dict(level=3)),
        "random2": (corpus("random", world * S + 5, seed=9),
                    dict(level=2)),
    }


def run(rank: int, world: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shards",))
        res = {name: compress_mesh(data, mesh, shard_len=S, ctx=CTX, **kw)
               for name, (data, kw) in cases(world).items()}
        with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()
