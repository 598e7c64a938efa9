"""The port's round-1 mesh encoder (parallel/pigz.py compress_mesh) on the
CPU: gloo groups of 2 and 4 ranks, spawned over a FileStore in a temporary
directory, one 4,096-byte shard a rank a step with 4,096 bytes of context
from the rank before.  Every rank must return the same member, equal byte
for byte to the port's device/pipeline.compress_device and to the JAX
package's jx/pipeline.compress_device at batch = world.  Tolerance:
exact."""

import pickle

import pytest
import torch
import torch.multiprocessing as tmp

from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import pipeline as pl
from flate_tpu_torch.parallel import compress_mesh

import _torch_pigz_worker as worker
from _torch_pigz_worker import CTX, S
from _torch_round1_ref import assert_round1_member

torch.set_num_threads(1)

WORLDS = [2, 4]
CASES = list(worker.cases(2))


def _spawn(world, d):
    """Each rank's results of one spawned gloo group of `world` ranks."""
    tmp.spawn(worker.run, args=(world, str(d / "store"), str(d)),
              nprocs=world, join=True)
    res = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return res


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """world -> each rank's members, one group of each size."""
    return {w: _spawn(w, tmp_path_factory.mktemp(f"pigz{w}"))
            for w in WORLDS}


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, groups):
    return request.param, groups[request.param]


@pytest.mark.parametrize("name", CASES)
def test_ranks_return_the_same_member(ranks, name):
    world, res = ranks
    for r in range(1, world):
        assert res[r][name] == res[0][name]


@pytest.mark.parametrize("name", CASES)
def test_member_equals_compress_device(ranks, name):
    """The member is the port's and the JAX package's round-1 member at
    batch = world, and decodes with zlib."""
    world, res = ranks
    data, kw = worker.cases(world)[name]
    blob = res[0][name]
    assert blob == pl.compress_device(data, shard_len=S, ctx=CTX,
                                      batch=world, device="cpu", **kw)
    kw = dict(kw)
    container = kw.pop("container", Container.GZIP)
    jax_decodes = assert_round1_member(blob, data, container, shard_len=S,
                                       ctx=CTX, batch=world, **kw)
    # the one member with a fixed block of literals 144-255
    assert jax_decodes == ((name, world) != ("mixed1_zlib", 4))


def test_cases_cover_steps_and_tails(ranks):
    """text6 takes three steps, the last with idle ranks, then a tail;
    mixed1_zlib ends on a step with no tail."""
    world, _ = ranks
    c = worker.cases(world)
    n = len(c["text6"][0])
    assert n // S == 2 * world + 1 and n % S
    assert len(c["mixed1_zlib"][0]) % (world * S) == 0


def test_ctx_above_shard_len_raises():
    with pytest.raises(ValueError, match="exceeds shard_len"):
        compress_mesh(b"x" * 100, shard_len=1024, ctx=2048)
