"""Mutation differential of the port's decode against the JAX package's host
decode, on the CPU.

The mutations are those of tests/test_decoder_fuzz_differential.py (its
generator and seed 20260817, chip_smoke.py `mutants`), over chip_smoke.py
`fuzz_seeds`: raw, the JAX test's six seeds and the port's own raw member
of text, 2,048 random bytes (one random.Random(3)) and text, at
shard_len 2048, ctx 1024, batch 2 (600 mutations); zlib, zlib's members at
levels 0, 1, 6, 9 and the port's own zlib member (300); gzip, CPython's
gzip at levels 1, 6 and 9 and two of the port's own members with their
FLT1 index: the one of that input, whose mixed shard re-routes it to the
chained route, and chip_smoke.py OWN_GZIP_167, which the indexed route
decodes (300).  Each mutation goes through the
port's one-shot decode and its streaming Decompressor.read_all() on the
CPU, and through the JAX package's (flate_tpu.<ns>.decompress(data,
device=False), flate_tpu.<ns>.decompressor(...).read_all()).  Each pair
must give the same bytes or an error of the same class; tolerance: exact.
The mutations run in chunks of 100, each a test.
"""

import functools
import io

import pytest
import torch

import flate_tpu as ft

import flate_tpu_torch as ftt
from flate_tpu_torch import errors

import chip_smoke as cs

NS = {"RAW": "flate", "ZLIB": "zlib", "GZIP": "gzip"}
COUNT = {"RAW": 600, "ZLIB": 300, "GZIP": 300}
CHUNK = 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def streams(container: str) -> list:
    own = cs.own_member(container, "cpu")
    return cs.mutants(cs.fuzz_seeds(container, own), COUNT[container])


def verdict(fn):
    try:
        return fn(), None
    except (errors.FlateError, ft.errors.FlateError) as e:
        return None, type(e).__name__


@pytest.mark.parametrize("container,chunk", [
    (c, k) for c in ("RAW", "ZLIB", "GZIP") for k in range(COUNT[c] // CHUNK)])
def test_mutations_agree(container, chunk):
    port, jax = getattr(ftt, NS[container]), getattr(ft, NS[container])
    bad = []
    for i in range(chunk * CHUNK, (chunk + 1) * CHUNK):
        d = streams(container)[i]
        want = (verdict(lambda: jax.decompress(d, device=False)),
                verdict(lambda: jax.decompressor(io.BytesIO(d)).read_all()))
        got = (verdict(lambda: port.decompress(d, device="cpu")),
               verdict(lambda: port.decompressor(
                   io.BytesIO(d), device="cpu").read_all()))
        for route, g, w in zip(("one-shot", "streamed"), got, want):
            if g != w:
                bad.append(f"#{i} {route}: {g[1] or len(g[0])} != "
                           f"{w[1] or len(w[0])}")
    assert not bad, bad


def test_seeds_as_described():
    """The raw seeds are the JAX test's six and the port's own member, the
    own gzip member carries the FLT1 index and mixes stored and coded
    shards, and every seed decodes."""
    from flate_tpu_torch.containers import Container, parse_header
    from flate_tpu_torch.device import inflate2 as i2
    from flate_tpu_torch.shard_index import parse_index_extra
    raw = cs.fuzz_seeds("RAW", cs.own_member("RAW", "cpu"))
    assert len(raw) == 7
    gz = cs.own_member("GZIP", "cpu")
    _, meta = parse_header(Container.GZIP, gz)
    assert parse_index_extra(meta.extra) is not None
    i2.STATS.clear()
    for container in NS:
        for seed in cs.fuzz_seeds(container, cs.own_member(container, "cpu")):
            out = getattr(ftt, NS[container]).decompress(seed, device="cpu")
            assert out == getattr(ft, NS[container]).decompress(
                seed, device=False)
    # the own gzip member's mixed shard re-routes it to the chained route;
    # OWN_GZIP_167 stays on the indexed route
    assert i2.STATS["segmented_reroutes"] == 1
    assert i2.STATS["decode_batch2"] == 2
    assert cs.mutants(raw, 3) == cs.mutants(raw, 5)[:3]
