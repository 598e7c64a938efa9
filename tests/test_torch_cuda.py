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
from flate_tpu_torch.device import pack, parse, pipeline2, runs, squeeze

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


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_cuda_bytes_equal_cpu(cuda, level):
    data = corpus("mixed", 5 * S - 77, seed=level)
    kw = dict(level=level, shard_len=S, ctx=CTX, batch=2)
    _build.LAUNCHES.clear()
    out = pipeline2.compress_device2(data, device=cuda, **kw)
    assert all(_build.LAUNCHES[n] > 0 for n in _build.ENCODE_KERNELS
               if n != "flate_extend2")          # B8: fp=True only
    assert out == pipeline2.compress_device2(data, device="cpu", **kw)
    assert zlib.decompress(out, 31) == data


def _bounds(cuda):
    min_src = torch.tensor([0, CTX - 100], dtype=torch.int32, device=cuda)
    limit = torch.tensor([CTX + S, CTX + 2000], dtype=torch.int32,
                         device=cuda)
    return min_src, limit


@pytest.mark.parametrize("nw,fp", [(8, True), (8, 4), (16, True), (8, False)])
@pytest.mark.parametrize("kind", KINDS)
def test_fp_top2_kernels_equal_plain(cuda, kind, nw, fp):
    """B1 with fingerprint words, B2 ranking by them with both outputs, B8
    on those outputs."""
    win = torch.from_numpy(windows(kind, seed=3)).to(cuda)
    W = win.shape[1]
    min_src, limit = _bounds(cuda)
    ne, nf = match2._split_words(nw, fp)
    k = match2._prep(win, ne, 4, nf)
    p = match2._prep_plain(win, ne, 4, nf)
    _eq(k[0], p[0])
    _eq(k[1], p[1])
    skey, order = torch.sort(k[0], dim=1)
    for K in (8, 48):
        kk = match2._run_matcher(skey, order, k[1], min_src, limit, W, K,
                                 32768, nf, True)
        pp = match2._run_matcher_plain(skey, order, k[1], min_src, limit, W,
                                       K, 32768, nf, True)
        _eq(kk[0], pp[0])
        _eq(kk[1], pp[1])
        _eq(match2._run_matcher(skey, order, k[1], min_src, limit, W, K,
                                32768, nf), pp[0])
    args = (kk[0] >> 16, kk[0] & 0xFFFF, kk[1] >> 16, kk[1] & 0xFFFF, limit,
            4 * ne)
    for a, b in zip(runs.extend_chains2(*args),
                    runs._extend_chains2_plain(*args)):
        _eq(a, b)
    ml, md = match2.find_matches_fused(
        win, torch.tensor([0, 100], device=cuda),
        torch.tensor([S, 2000], device=cuda), K=8, nw=nw, ctx=CTX, fp=fp)
    cl, cd = match2.find_matches_fused(
        win.cpu(), torch.tensor([0, 100]), torch.tensor([S, 2000]), K=8,
        nw=nw, ctx=CTX, fp=fp)
    _eq(ml, cl)
    _eq(md, cd)


@pytest.mark.parametrize("cap", [8, 16])
def test_extend_chains2_equal_plain(cuda, cap):
    """Dense synthetic candidates: long chains that switch between the two
    candidates, rows that end inside a chain, limits that cut the tail."""
    g = torch.Generator().manual_seed(cap)
    B, W = 3, 2 * 8192 + 37

    def cand():
        l = torch.where(torch.rand((B, W), generator=g) < 0.75, cap,
                        torch.randint(0, cap + 1, (B, W), generator=g))
        d = torch.where(torch.rand((B, W), generator=g) < 0.6,
                        torch.randint(4, 7, (B, W), generator=g),
                        torch.randint(0, 40, (B, W), generator=g))
        return l.to(torch.int32).to(cuda), d.to(torch.int32).to(cuda)
    l1, d1 = cand()
    l2, d2 = cand()
    limit = torch.tensor([W, W - 300, 40], dtype=torch.int32, device=cuda)
    for a, b in zip(runs.extend_chains2(l1, d1, l2, d2, limit, cap),
                    runs._extend_chains2_plain(l1, d1, l2, d2, limit, cap)):
        _eq(a, b)


@pytest.mark.parametrize("R,n", [(64, 1024), (16, 4096), (3, 8192),
                                 (2, 131072), (5, 100), (2, 8200),
                                 (2, 8208)])
def test_parse_walk_equal_plain(cuda, R, n):
    """B9 on rows staged in shared memory (n <= 8192) and chased in device
    memory, with and without 16-byte rows; steps overshoot the row's end."""
    g = torch.Generator().manual_seed(n)
    step = torch.where(torch.rand((R, n), generator=g) < 0.6, 1,
                       torch.randint(3, 259, (R, n), generator=g))
    step[0, : n // 2] = 1                     # a long literal run
    step = step.to(torch.int32).to(cuda)
    _eq(parse._parse_walk(step), parse._parse_walk_plain(step))


@pytest.mark.parametrize("lazy,max_lazy,blk", [(False, 0, 1024),
                                               (True, 32, 1024),
                                               (True, 258, 4096)])
def test_parse_entry_points_equal_cpu(cuda, lazy, max_lazy, blk):
    """parse_blocks, parse_walk and parse_doubling on the card (B9) against
    the CPU (the looped plain version)."""
    win = torch.from_numpy(windows("mixed", seed=9))
    ctx_len, valid = torch.tensor([CTX, 0]), torch.tensor([S, 1500])
    ml, md = match2.find_matches_fused(win, ctx_len, valid, K=12, nw=4,
                                       ctx=CTX)
    kw = dict(start=CTX, lazy=lazy, max_lazy=max_lazy)
    _build.LAUNCHES.clear()
    _eq(parse.parse_blocks(ml.to(cuda), md.to(cuda), blk=blk, **kw),
        parse.parse_blocks(ml, md, blk=blk, **kw))
    _eq(parse.parse_walk(ml.to(cuda), md.to(cuda), **kw),
        parse.parse_walk(ml, md, **kw))
    assert _build.LAUNCHES["flate_parse_walk"] == 2
    _eq(parse.parse_doubling(ml.to(cuda), md.to(cuda), **kw),
        parse.parse_walk(ml, md, **kw))


@pytest.mark.parametrize("grid_only", [False, True])
@pytest.mark.parametrize("blk", [1024, 4096])
def test_squeeze_equal_cpu(cuda, blk, grid_only):
    """The cost DP on the card against the CPU: code lengths (the float32
    log2 rounds to the same lengths), chosen lengths and masks."""
    win = torch.from_numpy(windows("text", seed=2))
    ctx_len, valid = torch.tensor([CTX, 0]), torch.tensor([S, 3000])
    ml, md = match2.find_matches_fused(win, ctx_len, valid, K=12, nw=4,
                                       ctx=CTX)
    ml, md = parse.truncate_matches(ml, md, CTX, blk)
    take, _ = parse.decide(ml, md, True, 32)
    starts = parse.parse_blocks(ml, md, start=CTX, blk=blk)

    def run(dev):
        a = [x[:, CTX:].to(dev) for x in (win, ml, md, starts, take)]
        ll, dd = squeeze.greedy_code_lengths(*a, valid.to(dev))
        return (ll, dd) + squeeze.squeeze_parse(*a[:3], ll, dd, blk=blk,
                                                grid_only=grid_only)
    _build.LAUNCHES.clear()
    for a, b in zip(run(cuda), run("cpu")):
        _eq(a, b)
    assert _build.LAUNCHES["flate_parse_walk"] == 1


def test_wrappers_reject_bad_tensors(cuda):
    win = torch.zeros((2, 100), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        runs.small_dist_runs(win, torch.zeros(2, device=cuda),
                             torch.zeros(2, device=cuda))
    ml = torch.zeros((2, 100), dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        runs.extend_chains(ml, ml, torch.zeros(2, device=cuda), 8)
    with pytest.raises(ValueError):
        runs.extend_chains2(ml, ml, ml, ml, torch.zeros(2, device=cuda), 8)
    with pytest.raises(TypeError):
        parse._parse_walk(torch.ones((2, 64), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        parse._parse_walk(torch.ones((2, 64), dtype=torch.int32,
                                     device=cuda)[:, ::2])


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
