"""The port's data-parallel mesh encoder (parallel/mesh2.py,
parallel/distributed.py) on the CPU: gloo groups of 2 and 4 ranks, spawned
over a FileStore in a temporary directory, shards of 2,048 bytes with
1,024 bytes of context and 2 shards a rank.  Every rank must return the
same member, equal byte for byte to the port's compress_device2 at batch =
world x per_device (which tests/test_torch_pipeline2.py holds to the JAX
package); the context crosses ranks by send/recv.  One test marked slow
holds the 4-rank member to the JAX compress_mesh2 on a 4-device CPU mesh
(interpret mode).  Tolerance: exact."""

import gzip as pygzip
import pickle
import zlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import pipeline2
from flate_tpu_torch.parallel import combined_crc32, distributed, make_mesh
from flate_tpu_torch.parallel.mesh2 import compress_mesh2

import _torch_mesh_worker as worker
from _torch_corpora import corpus
from _torch_mesh_worker import CTX, PER_DEVICE, S

torch.set_num_threads(1)

WORLDS = [2, 4]
WBITS = {Container.GZIP: 31, Container.ZLIB: 15, Container.RAW: -15}


def _spawn(world, d):
    """Each rank's results of one spawned gloo group of `world` ranks."""
    tmp.spawn(worker.run, args=(world, str(d / "store"), str(d),
                                world == 2), nprocs=world, join=True)
    res = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return res


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """world -> each rank's results, one group of each size (the 2-rank
    group also runs scaling_efficiency)."""
    return {w: _spawn(w, tmp_path_factory.mktemp(f"mesh{w}"))
            for w in WORLDS}


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, groups):
    return request.param, groups[request.param]


def _single(data, world, **kw):
    kw.pop("per_device")
    kw.pop("return_lens", None)
    return pipeline2.compress_device2(data, batch=world * PER_DEVICE,
                                      device="cpu", **kw)


MEMBERS = ["text6", "mixed1_zlib", "mixed3_raw", "period6"]


@pytest.mark.parametrize("name", MEMBERS)
def test_ranks_return_the_same_member(ranks, name):
    world, res = ranks
    for r in range(1, world):
        assert res[r][name] == res[0][name]


@pytest.mark.parametrize("name", MEMBERS)
def test_member_equals_compress_device2(ranks, name):
    world, res = ranks
    _, data, kw = worker.cases(world)[name]
    blob = res[0][name]
    assert blob == _single(data, world, **kw)
    assert zlib.decompress(blob, WBITS[kw.get("container",
                                               Container.GZIP)]) == data


def test_several_batches(ranks):
    """text6 spans three or more batches: the host carry of rank 0's first
    row from the batch before."""
    world, res = ranks
    _, data, kw = worker.cases(world)["text6"]
    assert -(-len(data) // S) > 2 * world * PER_DEVICE


def test_cross_rank_context(ranks):
    """Period-CTX random data compresses through back-references into the
    shard before, which for a rank's first shard lies on the rank before:
    only the first period is coded as literals (tests/test_mesh2.py bounds
    the member by CTX + n/50 at 7 KiB shards; at 2 KiB shards the ~40
    bytes of headers a shard exceed n/50, so the bound here is 2 CTX).
    Without the tail from the rank before, every rank's first shard would
    code its period again: more than world x CTX bytes."""
    world, res = ranks
    _, data, kw = worker.cases(world)["period6"]
    blob = res[0]["period6"]
    assert pygzip.decompress(blob) == data
    assert len(blob) < 2 * CTX
    alone = _single(data, world, independent=True, **kw)
    assert len(alone) > world * CTX


def test_regions_by_process_tile_the_stream(ranks):
    world, res = ranks
    _, data, kw = worker.cases(world)["regions_process"]
    blob, regions = res[0]["regions_process"]
    assert pygzip.decompress(blob) == data
    assert blob == res[0]["lens"][0]
    assert len(regions) == world              # one process a rank
    spans = sorted(sp for r in regions for sp in r)
    pos = 0
    for off, ln in spans:
        assert off == pos
        pos += ln
    assert pos == len(blob)
    for r in range(1, world):
        assert res[r]["regions_process"] == res[0]["regions_process"]


def test_regions_by_device_match_shard_ownership(ranks):
    """Rank d's spans are the bytes of the shards its rows encoded, from
    the per-shard lengths: the header on rank 0, the footer on the last."""
    world, res = ranks
    blob, regions = res[0]["regions_device"]
    assert (blob, regions) == res[0]["regions_process"]
    blob1, comp_lens, hdr_len, foot_len = res[0]["lens"]
    assert blob1 == blob
    batch = world * PER_DEVICE
    expected = [[] for _ in range(world)]

    def add(d, off, ln):
        exp = expected[d]
        if exp and exp[-1][0] + exp[-1][1] == off:
            exp[-1] = (exp[-1][0], exp[-1][1] + ln)
        else:
            exp.append((off, ln))

    add(0, 0, hdr_len)
    off = hdr_len
    for s, cl in enumerate(comp_lens):
        add((s % batch) // PER_DEVICE, off, cl)
        off += cl
    add(world - 1, off, foot_len)
    assert regions == expected


def test_initialize_in_a_group_returns_the_rank(ranks):
    world, res = ranks
    assert [r["initialize"] for r in res] == list(range(world))


def test_scaling_efficiency_runs(groups):
    """scaling_efficiency(size_mb=1, level=1, shard_len=2048) in the
    2-rank group: rank 0 alone, then both."""
    for r in groups[2]:
        s = r["scaling"]
        assert s["n_devices"] == 2
        assert s["gbps_1"] > 0 and s["gbps_n"] > 0
        assert s["efficiency"] > 0


def test_initialize_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") == 0
    assert not torch.distributed.is_initialized()


def test_combined_crc32():
    parts = [corpus("mixed", n, seed=n) for n in (0, 1, 2048, 70001)]
    assert combined_crc32(parts) == zlib.crc32(b"".join(parts))


def test_make_mesh_needs_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="default process group"):
        make_mesh()


def test_ctx_above_shard_len_raises():
    with pytest.raises(ValueError, match="exceeds shard_len"):
        compress_mesh2(b"x" * 100, shard_len=1024, ctx=2048)


def test_regions_by_must_be_known():
    with pytest.raises(ValueError, match="by must be"):
        distributed.compress_to_regions(b"x", by="host")


@pytest.mark.slow
def test_mesh2_equal_jax(groups):
    """The 4-rank member against the JAX compress_mesh2 on 4 CPU devices
    (interpret mode: minutes of tracing)."""
    import jax
    from flate_tpu.parallel.mesh2 import compress_mesh2 as j_compress_mesh2
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("shards",))
    _, data, kw = worker.cases(4)["text6"]
    ref = j_compress_mesh2(data, mesh, level=6, shard_len=S, ctx=CTX,
                           per_device=PER_DEVICE, interpret=True)
    assert groups[4][0]["text6"] == ref
