"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and nvcc; skips without a card.  Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import zlib

import pytest
import torch

from flate_tpu_torch import _build
from flate_tpu_torch import api
from flate_tpu_torch.device import anyinflate, encode2, inflate2, match2
from flate_tpu_torch.device import pack, parse, pipeline2, runs

from _torch_corpora import CTX, KINDS, S, corpus, windows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eq(a, b):
    torch.cuda.synchronize()
    assert a.shape == b.shape
    assert torch.equal(a.cpu().to(torch.int64), b.cpu().to(torch.int64))


@pytest.mark.parametrize("kind", KINDS)
def test_kernels_equal_plain(cuda, kind):
    win = torch.from_numpy(windows(kind, seed=3)).to(cuda)
    W = win.shape[1]
    min_src = torch.tensor([0, CTX - 100], dtype=torch.int32, device=cuda)
    limit = torch.tensor([CTX + S, CTX + 2000], dtype=torch.int32,
                         device=cuda)
    for nw, hb in ((2, 4), (4, 4), (1, 3), (16, 4)):
        k = match2._prep(win, nw, hb)
        p = match2._prep_plain(win, nw, hb)
        _eq(k[0], p[0])
        _eq(k[1], p[1])
        skey, order = torch.sort(k[0], dim=1)
        for K in (4, 12, 160):
            _eq(match2._run_matcher(skey, order, k[1], min_src, limit, W, K,
                                    32768),
                match2._run_matcher_plain(skey, order, k[1], min_src, limit,
                                          W, K, 32768))
    kl, kd = runs.small_dist_runs(win, limit, min_src)
    pl, pd = runs._small_dist_runs_plain(win, limit, min_src)
    _eq(kl, pl)
    _eq(kd, pd)
    ml, md = match2.find_matches_fused(
        win, torch.tensor([0, 100], device=cuda),
        torch.tensor([S, 2000], device=cuda), K=12, nw=4, ctx=CTX)
    for cap in (8, 16):
        _eq(runs.extend_chains(ml, md, limit, cap),
            runs._extend_chains_plain(ml, md, limit, cap))


def test_pack_equal_plain(cuda):
    win = torch.from_numpy(windows("mixed", seed=8)).to(cuda)
    valid = torch.tensor([S, 1500], dtype=torch.int32, device=cuda)
    ml, md = match2.find_matches_fused(
        win, torch.tensor([CTX, 0], device=cuda), valid, K=4, nw=2, ctx=CTX)
    ml, md = parse.truncate_matches(ml, md, CTX, 1024)
    take, _ = parse.decide(ml, md, False, 0)
    starts = parse.parse_blocks(ml, md, start=CTX, lazy=False, blk=1024)
    seg = encode2.seg_size(S, 1024)
    vals, bits, _, _ = encode2.build_fields(
        win[:, CTX:], ml[:, CTX:], md[:, CTX:], starts[:, CTX:],
        take[:, CTX:], valid, torch.tensor([0, 1], device=cuda), S, seg)
    incl = torch.cumsum(bits, dim=1, dtype=torch.int32)
    off = (incl - bits).contiguous()
    n = pipeline2._nwr(S, seg) * 128
    _eq(pack._place(vals, off, n), pack._place_plain(vals, off, n))


@pytest.mark.parametrize("level", [1, 3])
def test_cuda_bytes_equal_cpu(cuda, level):
    data = corpus("mixed", 5 * S - 77, seed=level)
    kw = dict(level=level, shard_len=S, ctx=CTX, batch=2)
    _build.LAUNCHES.clear()
    out = pipeline2.compress_device2(data, device=cuda, **kw)
    assert all(_build.LAUNCHES[n] > 0 for n in _build.ENCODE_KERNELS)
    assert out == pipeline2.compress_device2(data, device="cpu", **kw)
    assert zlib.decompress(out, 31) == data


def test_wrappers_reject_bad_tensors(cuda):
    win = torch.zeros((2, 100), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        runs.small_dist_runs(win, torch.zeros(2, device=cuda),
                             torch.zeros(2, device=cuda))
    ml = torch.zeros((2, 100), dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        runs.extend_chains(ml, ml, torch.zeros(2, device=cuda), 8)


# ---------------------------------------------------------------------------
# decode kernels (B6 lane walk, B7 serial walk)
# ---------------------------------------------------------------------------

def _coded_args(data, level, shard_len, ctx, dev):
    """decode_batch arguments of the leading coded shards of `data` as the
    port encodes it, on `dev`."""
    blob = pipeline2.compress_device2(data, level=level, shard_len=shard_len,
                                      ctx=ctx, batch=4, device=dev)
    from flate_tpu_torch.containers import Container, parse_header
    from flate_tpu_torch.shard_index import parse_index_extra
    hdr, meta = parse_header(Container.GZIP, blob)
    comp_lens, out_lens, _ = parse_index_extra(meta.extra)
    run, off = [], hdr
    for c, o in zip(comp_lens, out_lens):
        sh = blob[off:off + int(c)]
        off += int(c)
        p = inflate2.plan_shard(sh, int(o))
        if p.kind != "coded":
            break
        run.append((p, sh))
    return inflate2.pack_coded_run(run, b"", dev)


@pytest.mark.parametrize("G,J", [(256, 96), (512, 2), (256, 1), (2048, 96)])
@pytest.mark.parametrize("where", ["true", "lane0", "later"])
def test_lane_walk_equal_plain(cuda, G, J, where):
    args = _coded_args(corpus("text", 4 * S, seed=2), 1, S, CTX, cuda)
    word = inflate2._pass1(args[0], *args[3:9])
    start = {"true": args[2], "lane0": torch.full_like(args[2], 3),
             "later": torch.full_like(args[2], 2 * G + 17)}[where]
    nbits = 8 * args[1]
    km, kj = inflate2._lane_walk(word, start, nbits, G=G, J=J)
    pm, pj = inflate2._lane_walk_plain(word, start, nbits, G, J)
    _eq(km, pm)
    _eq(kj, pj)


@pytest.mark.parametrize("NS", [S + 128, 100])
def test_walk_equal_plain(cuda, NS):
    args = _coded_args(corpus("text", 4 * S, seed=2), 3, S, CTX, cuda)
    word = inflate2._pass1(args[0], *args[3:9])
    nbits = 8 * args[1]
    nbits[-1] = 900                      # a row that ends before its EOB
    ko, kc = inflate2._walk(word, args[2], nbits, NS)
    po, pc = inflate2._walk_plain(word, args[2], nbits, NS)
    _eq(kc, pc)
    _eq(ko, po)


def test_decode_kernels_full_width(cuda):
    """8 shards of 128 KiB at the decode's own widths."""
    data = (corpus("text", 36000, seed=1) * 30)[:8 * 131072]
    args = _coded_args(data, 3, 131072, 32768, cuda)
    assert args[0].shape[0] == 8
    word = inflate2._pass1(args[0], *args[3:9])
    nbits = 8 * args[1]
    km, kj = inflate2._lane_walk(word, args[2], nbits)
    pm, pj = inflate2._lane_walk_plain(word, args[2], nbits,
                                       inflate2.LANE_G, inflate2.LANE_J)
    _eq(km, pm)
    _eq(kj, pj)
    NS = 131072 + 128
    ko, kc = inflate2._walk(word, args[2], nbits, NS)
    po, pc = inflate2._walk_plain(word, args[2], nbits, NS)
    _eq(kc, pc)
    _eq(ko, po)


def test_lane_walk_widest_span(cuda):
    """The chained route's widest span, 2 MiB of compressed bytes: 8192
    lanes a row, on synthetic words (adv 1..48, no other field)."""
    g = torch.Generator().manual_seed(5)
    N = 8 << 21
    word = torch.randint(1, 49, (2, N), generator=g, dtype=torch.int32
                         ).to(cuda)
    start = torch.tensor([5, 3 * inflate2.LANE_G + 9], dtype=torch.int32,
                         device=cuda)
    nbits = torch.tensor([N, N - 5 * inflate2.LANE_G - 1], dtype=torch.int32,
                         device=cuda)
    km, kj = inflate2._lane_walk(word, start, nbits)
    pm, pj = inflate2._lane_walk_plain(word, start, nbits, inflate2.LANE_G,
                                       inflate2.LANE_J)
    _eq(km, pm)
    _eq(kj, pj)
    ko, kc = inflate2._walk(word, start, nbits, 4096)
    po, pc = inflate2._walk_plain(word, start, nbits, 4096)
    _eq(kc, pc)
    _eq(ko, po)


def test_decode_wrappers_reject_bad_tensors(cuda):
    word = torch.zeros((2, 4096), dtype=torch.int64, device=cuda)
    z = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        inflate2._lane_walk(word, z, z)
    with pytest.raises(TypeError):
        inflate2._walk(word, z, z, 128)
    with pytest.raises(ValueError):
        inflate2._walk(word.to(torch.int32)[:, ::2], z, z, 128)


@pytest.mark.parametrize("walk", ["lanes", "serial"])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_decode_round_trip(cuda, kind, walk):
    data = corpus(kind, 5 * S - 77, seed=4)
    blob = pipeline2.compress_device2(data, level=3, shard_len=S, ctx=CTX,
                                      batch=2, device=cuda)
    _build.LAUNCHES.clear()
    assert api.gzip.decompress(blob, batch=2, walk=walk) == data
    assert api.gzip.decompress(blob, batch=2, walk=walk, device="cpu") == data
    assert api.zlib.decompress(zlib.compress(data, 6)) == data
    assert anyinflate.decompress_device_any(
        zlib.compress(data, 9, 31), device=cuda) == data
