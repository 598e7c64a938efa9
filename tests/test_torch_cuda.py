"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and nvcc; skips without a card.  Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import zlib

import numpy as np
import pytest
import torch

from flate_tpu_torch import _build
from flate_tpu_torch import api
from flate_tpu_torch.device import anyinflate, bitonic, encode2, inflate2
from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import checksum, graphs, match2
from flate_tpu_torch.device import pack, parse, pipeline2, runs, scan
from flate_tpu_torch.device import squeeze

from _torch_corpora import (CTX, KINDS, PINNED, S, WBITS,
                            big_block_streams, corpus,
                            first_stage_difference, lane_edge_rows,
                            long_block_streams, pack_edge_rows,
                            parse_edge_rows, scan_cases, sha256,
                            small_blocks, small_run_edge_rows, stream_encode,
                            sweep_cases, sweep_id, sweep_input,
                            too_far_streams, trap_stream, walk_edge_rows,
                            windows)
from chip_smoke import PROD_PINNED, prod_id, prod_input

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
            _eq(match2._run_matcher(skey, order, win, k[1], min_src, limit,
                                    W, K, 32768, nw, hb),
                match2._run_matcher_plain(skey, order, win, k[1], min_src,
                                          limit, W, K, 32768, nw, hb))
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


@pytest.mark.parametrize("W", [3 * 8192 + 100, 1000, 4096, 2 * 4096 + 4094,
                               163840])
def test_small_runs_edges_equal_plain(cuda, W):
    """B3 on tests/_torch_corpora.py small_run_edge_rows: runs of 257, 258
    and 259 bytes and of periods 2-8 across every tile end, limit inside a
    run and inside the halo, min_src inside a tile, d = 8 at tile starts,
    limit <= min_src; W not a multiple of the tile (byte staging at W % 16
    != 0, 4-byte stores at W % 4 != 0), W below it, and the batch's W."""
    win, limit, min_src = (torch.from_numpy(x).to(cuda)
                           for x in small_run_edge_rows(W, seed=W))
    kl, kd = runs.small_dist_runs(win, limit, min_src)
    pl, pd = runs._small_dist_runs_plain(win, limit, min_src)
    _eq(kl, pl)
    _eq(kd, pd)


def test_pack_equal_plain(cuda):
    """B5 on build_fields' fields (int32 u32 bit patterns), its offsets
    from its own scan, against the plain cumsum and placement."""
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
    assert vals.dtype == torch.int32
    nwr = pipeline2._nwr(S, seg)
    _build.LAUNCHES.clear()
    kw, kt = pack.pack_fields(vals, bits, nwr)
    assert _build.LAUNCHES["flate_pack"] == 1
    pw, pt = pack._pack_plain(vals, bits, nwr * 128)
    _eq(kw.reshape(2, -1), pw)
    _eq(kt, pt)


def _pack_both(vals, bits, nwr, cuda):
    """B5 and its plain version on the card, on numpy (vals uint32, bits
    int32) rows."""
    v = torch.from_numpy(vals.view(np.int32)).to(cuda)
    b = torch.from_numpy(bits).to(cuda)
    kw, kt = pack.pack_fields(v, b, nwr)
    pw, pt = pack._pack_plain(v, b, nwr * 128)
    _eq(kw.reshape(v.shape[0], -1), pw)
    _eq(kt, pt)
    return pw


@pytest.mark.parametrize("slots,nwr", [(11264, 14), (283648, 262),
                                       (4096 * 3 + 2, 14)])
def test_pack_edges_equal_plain(cuda, slots, nwr):
    """B5 on tests/_torch_corpora.py pack_edge_rows at the small shards'
    and the batch's slot counts and at a count no multiple of 4 (scalar
    loads): fields across every tile end, a dead tile, a stream ending on
    a word boundary at a tile end, a tile starting a word, a tile within
    one word, an empty row, a full row; and a row of 28-bit fields that
    overruns the word grid (bits past it are dropped)."""
    vals, bits = pack_edge_rows(slots, (nwr - 5) * 128 * 32, seed=slots)
    over = np.full((1, slots), 28, np.int32)
    over_v = np.random.default_rng(slots).integers(
        0, 2**28, (1, slots)).astype(np.uint32)
    pw = _pack_both(np.concatenate([vals, over_v]),
                    np.concatenate([bits, over]), nwr, cuda)
    assert int((pw[-1] == 0).sum()) == 0 and int(pw[-3].abs().sum()) == 0


@pytest.mark.parametrize("fill", [0.05, 0.3, 1.0])
def test_pack_random_fill_equal_plain(cuda, fill):
    """B5 at the batch's shape (64 rows x 283,648 slots: 4,480 tiles in
    flight) on random fields (1-28 bits) over a share `fill` of the slots;
    even rows are cut to fit the word grid, odd rows may overrun it."""
    B, slots, nwr = 64, 283648, 262
    rng = np.random.default_rng(int(fill * 100))
    bits = rng.integers(1, 29, (B, slots)).astype(np.int64)
    bits = np.where(rng.random((B, slots)) < fill, bits, 0)
    fits = np.cumsum(bits, axis=1) <= nwr * 128 * 32
    bits[::2] = np.where(fits[::2], bits[::2], 0)
    vals = rng.integers(0, 2**28, (B, slots), dtype=np.int64)
    vals = np.where(bits > 0, vals & ((1 << bits) - 1), 0)
    _pack_both(vals.astype(np.uint32), bits.astype(np.int32), nwr, cuda)


def test_pack_graph_replay(cuda):
    """B5 captured in a CUDA graph and replayed on new fields: the tiles'
    status words and ticket are zeroed in the call, so every replay
    starts afresh."""
    slots, nwr = 283648, 262
    vals, bits = pack_edge_rows(slots, (nwr - 5) * 128 * 32, seed=1)
    v = torch.from_numpy(vals.view(np.int32)).to(cuda)
    b = torch.from_numpy(bits).to(cuda)
    pack.pack_fields(v, b, nwr)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        kw, kt = pack.pack_fields(v, b, nwr)
    for seed in (2, 3):
        nv, nb = pack_edge_rows(slots, (nwr - 5) * 128 * 32, seed=seed)
        v.copy_(torch.from_numpy(nv.view(np.int32)))
        b.copy_(torch.from_numpy(nb))
        g.replay()
        pw, pt = pack._pack_plain(v, b, nwr * 128)
        _eq(kw.reshape(v.shape[0], -1), pw)
        _eq(kt, pt)


def test_pack_compact_grid_full_width(cuda):
    """B5 at 64 x 142,848 slots (the compact grid of a 128 KiB shard, the
    JAX package's slot_count_compact) on random fields over 45 % of
    283,648 slots, each row's live fields moved to the front on the host:
    equal to its plain version and to B5's words on the full grid."""
    B, slots, SC, nwr = 64, 283648, 142848, 262
    rng = np.random.default_rng(45)
    bits = rng.integers(1, 16, (B, slots)) * (rng.random((B, slots)) < 0.45)
    vals = rng.integers(0, 2**15, (B, slots)) & ((1 << bits) - 1)
    vc = np.zeros((B, SC), np.uint32)
    bc = np.zeros((B, SC), np.int32)
    for r in range(B):
        live = bits[r] > 0
        vc[r, :live.sum()] = vals[r][live]
        bc[r, :live.sum()] = bits[r][live]
    pw = _pack_both(vc, bc, nwr, cuda)
    fw, ft = pack.pack_fields(
        torch.from_numpy(vals.astype(np.int32)).to(cuda),
        torch.from_numpy(bits.astype(np.int32)).to(cuda), nwr)
    cw, ct = pack.pack_fields(torch.from_numpy(vc.view(np.int32)).to(cuda),
                              torch.from_numpy(bc).to(cuda), nwr)
    _eq(cw, fw)
    _eq(ct, ft)
    _eq(cw.reshape(B, -1), pw)


PREP_KNOBS = [(4, 8, 0), (3, 1, 0), (4, 2, 2), (4, 2, 5), (4, 3, 1)]


@pytest.mark.parametrize("hb,ne,nf", PREP_KNOBS)
@pytest.mark.parametrize("W", [1000, 4099, 3 * 8192 + 100, 163840])
def test_prep_equal_plain(cuda, W, hb, ne, nf):
    """B1 against its plain version: keys (int32, u32 key ^ 2^31) and
    fingerprint words, W below a tile, no multiple of 16 or of the tile,
    and the batch's W; the 3-byte hash, no fingerprint, and up to 5
    fingerprint words over 2 exact ones (nw = 64: a 255-byte halo); each
    from a 16-byte aligned window and from one a byte past it (byte
    copies)."""
    B = 3
    raw = corpus("mixed", B * W + 16, seed=W)
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(cuda)
    for off in (0, 1):
        win = flat[off:off + B * W].view(B, W)
        assert (win.data_ptr() % 16 == 0) == (off == 0)
        k = match2._prep(win, ne, hb, nf)
        p = match2._prep_plain(win, ne, hb, nf)
        assert k[0].dtype == torch.int32
        _eq(k[0], p[0])
        _eq(k[1], p[1])


@pytest.mark.parametrize("case", sweep_cases(), ids=sweep_id)
def test_cuda_bytes_equal_cpu(cuda, case):
    """The shape sweep (tests/_torch_corpora.py sweep_cases: the own
    members of chip_smoke.py phase 17, 57 seeded combinations of shard_len
    1024-131072, ctx 512-32768 (above the shard too), batch 1-8, levels
    1-9 and the three containers, the pinned cases, the level sweep at
    4096 / 512 / 2): the card's bytes equal the CPU's, staged, fused (one
    CUDA graph a batch) and through the streaming compressor with a flush
    in the middle, each decodes with zlib, and on the PINNED cases they
    are the JAX package's bytes (their sha256).  On a difference the
    message names the first stage of encode_stages that differs."""
    level, shard_len, ctx, batch, container, name = case
    data = sweep_input(name, level, shard_len, batch)
    kw = dict(level=level, container=Container[container],
              shard_len=shard_len, ctx=ctx, batch=batch)
    _build.LAUNCHES.clear()
    out = pipeline2.compress_device2(data, device=cuda, **kw)
    assert all(_build.LAUNCHES[n] > 0 for n in _build.ENCODE_KERNELS
               if n != "flate_extend2")          # B8: fp=True only
    cpu = pipeline2.compress_device2(data, device="cpu", **kw)
    if out != cpu:
        pytest.fail(f"staged: {len(out)} != {len(cpu)} bytes; first "
                    + str(first_stage_difference(data, level, shard_len, ctx,
                                                 batch, cuda, container)))
    assert zlib.decompress(out, WBITS[container]) == data
    if case in PINNED:
        assert sha256(out) == PINNED[case]
    try:
        fused = pipeline2.compress_device2(data, device=cuda, fused=True,
                                           **kw)
    finally:
        graphs.clear()
    assert fused == cpu
    streamed = stream_encode(case, data, cuda)
    assert streamed == stream_encode(case, data, "cpu")
    assert zlib.decompress(streamed, WBITS[container]) == data


@pytest.mark.parametrize("case", list(PROD_PINNED), ids=prod_id)
def test_cuda_prodshape_bytes_equal_pin(cuda, case):
    """The headline's shard shape (chip_smoke.py PROD_PINNED: 128 KiB shards,
    32 KiB context, levels 1-9): the card's bytes, staged and fused, are the
    JAX package's (their sha256) and decode with zlib."""
    level, shard_len, ctx, batch, container, name = case
    data = prod_input(name)
    kw = dict(level=level, container=Container[container],
              shard_len=shard_len, ctx=ctx, batch=batch)
    out = pipeline2.compress_device2(data, device=cuda, **kw)
    assert sha256(out) == PROD_PINNED[case], len(out)
    assert zlib.decompress(out, WBITS[container]) == data
    try:
        fused = pipeline2.compress_device2(data, device=cuda, fused=True,
                                           **kw)
    finally:
        graphs.clear()
    assert fused == out


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
        kk = match2._run_matcher(skey, order, win, k[1], min_src, limit, W,
                                 K, 32768, ne, top2=True)
        pp = match2._run_matcher_plain(skey, order, win, k[1], min_src,
                                       limit, W, K, 32768, ne, top2=True)
        _eq(kk[0], pp[0])
        _eq(kk[1], pp[1])
        _eq(match2._run_matcher(skey, order, win, k[1], min_src, limit, W,
                                K, 32768, ne), pp[0])
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


@pytest.mark.parametrize("R,n", [(9, 1024), (9, 4096), (9, 8192), (9, 8200),
                                 (9, 1000), (7, 8199), (6, 40000)])
def test_parse_walk_edges_equal_plain(cuda, R, n):
    """B9 with a step of 0, -5, n, 70,000, 2^31 - 1 or 8,195 on each row's
    chain (tests/_torch_corpora.py parse_edge_rows): rows staged by a warp
    (n <= 8192, four a block, the last block part full) and rows streamed
    through the shared-memory ring (the 8,195 step skips a chunk), with and
    without 16-byte rows."""
    step = torch.from_numpy(parse_edge_rows(R, n, seed=n)).to(cuda)
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
    """The cost DP on the card against the CPU: code lengths (the same
    step function of the same float32 p), chosen lengths and masks."""
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


def test_entropy_code_lens_equal_cpu(cuda):
    """The squeeze's rounded code lengths on the card against the CPU on
    every count pair near a step (chip_smoke.length_step_pairs: totals up
    to 131,073), at the distance histogram's width."""
    from chip_smoke import length_step_pairs
    h, t = length_step_pairs()
    rows = torch.zeros((len(h), 30), dtype=torch.int32)
    rows[:, 0], rows[:, 1] = torch.from_numpy(h), torch.from_numpy(t - h)
    _eq(squeeze._entropy_code_lens(rows.to(cuda)),
        squeeze._entropy_code_lens(rows))


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
    v = torch.zeros((2, 100), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pack.pack_fields(v, v[:, :50], 1)
    w8 = torch.zeros((2, 100), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        match2._prep(w8, 1, 5)
    key, fps = match2._prep(w8, 1, 4)
    with pytest.raises(TypeError):              # keys are int32 since B1's
        match2._run_matcher(key.to(torch.int64), key, w8, fps,  # redesign
                            v[:, 0], v[:, 0], 100, 4, 32768, 1)


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


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("G,NL,J,L", [(256, 3, 96, 2), (256, 17, 96, 4),
                                      (256, 17, 1, 16), (512, 17, 2, 4),
                                      (2048, 17, 96, 8), (128, 17, 96, 31),
                                      (256, 1, 96, 1)])
def test_lane_walk_edges_equal_plain(cuda, G, NL, J, L, staged):
    """B6 at L lanes a block, staged in shared memory or walking device
    memory, on tests/_torch_corpora.py lane_edge_rows (exits 0..62 past a
    lane's end, start inside a symbol, in lane 1, in the last lane and past
    nbits, nbits mid-lane and 0) plus two rows that start in block 1's first
    lane and in its halo lane; NL of 1, 3 and 17 (not multiples of L), J of
    1 and 2 (joins that fail)."""
    word, start, nbits = (torch.from_numpy(x).to(cuda)
                          for x in lane_edge_rows(G, NL, seed=G + NL))
    if NL > L:
        word = torch.cat([word, word[1:2], word[1:2]])
        start = torch.cat([start, torch.tensor(
            [L * G + 5, (L - 1) * G + 5], dtype=torch.int32, device=cuda)])
        nbits = torch.cat([nbits, nbits[1:2], nbits[1:2]])
    km, kj = inflate2._lane_walk_cuda(word, start, nbits, G, J, L=L,
                                      staged=staged)
    pm, pj = inflate2._lane_walk_plain(word, start, nbits, G, J)
    _eq(km, pm)
    _eq(kj, pj)


@pytest.mark.parametrize("G", [92928, 93056])
def test_lane_walk_widest_lanes(cuda, G):
    """The widest G whose lane and halo lane stage in shared memory, and the
    narrowest that does not: the wrapper then takes the device-memory
    variant."""
    word, start, nbits = (torch.from_numpy(x).to(cuda)
                          for x in lane_edge_rows(G, 3, seed=1))
    assert inflate2._lanes_per_block(6, 3, G, 132) == (1, G == 92928)
    km, kj = inflate2._lane_walk(word, start, nbits, G=G, J=96)
    pm, pj = inflate2._lane_walk_plain(word, start, nbits, G, 96)
    _eq(km, pm)
    _eq(kj, pj)


def test_lane_walk_chained_shape(cuda):
    """A chained-route row chunk: 64 rows of 2^19 positions (2^25 in all),
    16,384 lanes in many waves, on synthetic words (adv 1..48)."""
    g = torch.Generator().manual_seed(7)
    N = 1 << 19
    word = torch.randint(1, 49, (64, N), generator=g,
                         dtype=torch.int32).to(cuda)
    start = torch.randint(0, 5000, (64,), generator=g,
                          dtype=torch.int32).to(cuda)
    nbits = N - torch.randint(0, 300000, (64,), generator=g,
                              dtype=torch.int32).to(cuda)
    km, kj = inflate2._lane_walk(word, start, nbits)
    pm, pj = inflate2._lane_walk_plain(word, start, nbits, inflate2.LANE_G,
                                       inflate2.LANE_J)
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


@pytest.mark.parametrize("N,NS", [(36864, 40000), (36864, 1000),
                                  (36866, 4098)])
def test_walk_ring_edges(cuda, N, NS):
    """B7 on rows whose chains cross every 8192-word ring chunk
    (tests/_torch_corpora.py walk_edge_rows): adv 63, 1 and 0 on a chunk's
    last word, an end-of-block word first, start == nbits, nbits > N, a
    chunk of one-bit steps (the staged output fills mid-chunk), NS cutting
    the chain, rows of unequal length in one launch; N = 36866 and NS =
    4098 take the 4-byte copies and stores."""
    word, start, nbits = (torch.from_numpy(x).to(cuda)
                          for x in walk_edge_rows(N, seed=N))
    ko, kc = inflate2._walk(word, start, nbits, NS)
    po, pc = inflate2._walk_plain(word, start, nbits, NS)
    _eq(kc, pc)
    _eq(ko, po)
    assert int(pc[1]) == 1 and int(pc[2]) == 0 and int(pc[4]) == NS


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


@pytest.mark.parametrize("case", ["full", "mix", "dup_full", "dup_one",
                                  "no_stages"])
def test_bitonic_equal_plain(cuda, case):
    """B10 against its plain version: the full 171-substage network on 2
    rows, the probe's calibrate mix, keys from 0-15 (operands duplicated),
    and an empty stage list."""
    rng = np.random.default_rng(5)
    shape = (2, bitonic.R, bitonic.C)
    high = 16 if case.startswith("dup") else 2**32
    key = torch.from_numpy(rng.integers(0, high, shape, dtype=np.uint32))
    ops = [torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32))
           for _ in range(8)]
    stages = {"mix": bitonic.CALIBRATE_MIX, "dup_one": ((1, 2),),
              "no_stages": ()}.get(case,
                                   bitonic.bitonic_stages(bitonic.R * bitonic.C))
    key, ops = key.to(cuda), [o.to(cuda) for o in ops]
    got = bitonic.run(key, ops, stages)
    want = bitonic._run_plain(key, ops, stages)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32
        _eq(g.view(torch.int32), w.view(torch.int32))


T10 = bitonic.TILE
N10 = bitonic.R * bitonic.C
# j = tile/2, tile, 2*tile; six consecutive j >= tile (one j twice)
AROUND_TILE = ((T10 // 2, N10), (T10, N10), (2 * T10, N10),
               (T10 // 2, 4 * T10), (8 * T10, N10), (4 * T10, N10),
               (2 * T10, N10), (T10, N10), (4 * T10, 2 * N10),
               (4 * T10, 8 * T10), (T10, 2 * T10), (1, 2))


@pytest.mark.parametrize("case,passes", [
    ("around_tile", 6), ("short_rows", 1), ("all_equal", 9),
    ("many_operands", 9), ("tiny_rows", 1)])
def test_bitonic_passes_equal_plain(cuda, case, passes):
    """B10's passes against its plain version: substages at and around the
    tile's size and a run of more than 4 device-memory substages; rows of
    2^12 (3 of them: the batch's one tile is cut short); all keys equal;
    17 operands (gathered as records of 8, 8 and 1); rows of 8."""
    rng = np.random.default_rng(11)
    shape = {"short_rows": (3, 32, 128), "tiny_rows": (5, 2, 4)}.get(
        case, (2, bitonic.R, bitonic.C))
    n = shape[1] * shape[2]
    stages = AROUND_TILE if case == "around_tile" else \
        bitonic.bitonic_stages(n)
    assert len(bitonic.plan_passes(stages, n)) == passes
    if case == "all_equal":
        key = np.full(shape, 0xDEADBEEF, dtype=np.uint32)
    else:
        key = rng.integers(0, 1 << 20, shape, dtype=np.uint32)
    nops = 17 if case == "many_operands" else 8
    ops = [torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32)
                            ).to(cuda) for _ in range(nops)]
    key = torch.from_numpy(key).to(cuda)
    _build.LAUNCHES.clear()
    got = bitonic.run(key, ops, stages)
    assert _build.LAUNCHES["flate_bitonic"] == 1
    want = bitonic._run_plain(key, ops, stages)
    assert len(got) == len(want) == 1 + nops
    for g, w in zip(got, want):
        _eq(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("case", ["k160_ne16", "k3", "fp_top2", "tail",
                                  "min_src", "odd_width", "ne3", "ne6",
                                  "ne40", "fp3_top2"])
@pytest.mark.parametrize("kind", ["text", "runs"])
def test_matcher_cases_equal_plain(cuda, kind, case):
    """B2 against its plain version: K = 160 with 16 exact words (level
    9), the 3-byte K3 pass (K = 16, one word masked to 3 bytes, dist <=
    4096), fingerprint ranking with both outputs, a tail row (limit short
    of W), rows whose context is short (min_src > 0), a window whose
    width is no multiple of 4, and exact word counts no level uses (3, 6
    and 40: rows staged with 4, 8 and 65 words, lengths cut at 4*ne) and
    fp=3 (3 exact + 2 fingerprint words)."""
    win = torch.from_numpy(windows(kind, seed=12))
    if case == "odd_width":
        win = win[:, :-3].contiguous()
    win = win.to(cuda)
    W = win.shape[1]
    K, nw, hb, max_dist, fp = {
        "k160_ne16": (160, 16, 4, 32768, False),
        "k3": (16, 1, 3, 4096, False),
        "fp_top2": (48, 8, 4, 32768, True),
        "ne3": (48, 3, 4, 32768, False),
        "ne6": (48, 6, 4, 32768, False),
        "ne40": (48, 40, 4, 32768, False),
        "fp3_top2": (48, 12, 4, 32768, 3)}.get(case, (48, 8, 4, 32768,
                                                     False))
    min_src = torch.tensor([0, 0], dtype=torch.int32, device=cuda)
    limit = torch.tensor([W, W], dtype=torch.int32, device=cuda)
    if case == "tail":
        limit[1] = CTX + 1234
    if case == "min_src":
        min_src[:] = torch.tensor([CTX - 300, CTX - 7])
    ne, nf = match2._split_words(nw, fp)
    key, fps = match2._prep(win, ne, hb, nf)
    skey, order = torch.sort(key, dim=1)
    top2 = case.endswith("top2")
    got = match2._run_matcher(skey, order, win, fps, min_src, limit, W, K,
                              max_dist, ne, hb, top2)
    want = match2._run_matcher_plain(skey, order, win, fps, min_src, limit,
                                     W, K, max_dist, ne, hb, top2)
    for g, w in zip(got if top2 else (got,), want if top2 else (want,)):
        _eq(g, w)
        assert int((w != 0).sum()) > 0


@pytest.mark.parametrize("K,nw", [(625, 17), (1024, 20), (1024, 65)])
@pytest.mark.parametrize("kind", ["text", "runs"])
def test_matcher_large_k_equal_plain(cuda, kind, K, nw):
    """B2 where the staged rows' words would overflow shared memory (from
    17 exact words rows are staged with 65; K >= 625): the halo rows'
    words are built from the window as they are compared."""
    win = torch.from_numpy(windows(kind, seed=13)).to(cuda)
    W = win.shape[1]
    min_src = torch.zeros(2, dtype=torch.int32, device=cuda)
    limit = torch.tensor([W, W - 77], dtype=torch.int32, device=cuda)
    key, fps = match2._prep(win, nw, 4)
    skey, order = torch.sort(key, dim=1)
    args = (skey, order, win, fps, min_src, limit, W, K, 32768, nw, 4, True)
    got = match2._run_matcher(*args)
    want = match2._run_matcher_plain(*args)
    for g, w in zip(got, want):
        _eq(g, w)
        assert int((w != 0).sum()) > 0


def test_device_encoder_cuda_equal_cpu(cuda):
    """The streaming encoder on the card gives the CPU's bytes, split
    calls, a dictionary and the final call included."""
    data = corpus("mixed", 7 * S + 17, seed=4)
    d = corpus("text", 700, seed=5)
    outs = []
    for dev in (cuda, "cpu"):
        enc = pipeline2.DeviceEncoder(level=6, shard_len=S, ctx=CTX, batch=3,
                                      dictionary=d, device=dev)
        outs.append(enc.encode(data[:3 * S + 17])
                    + enc.encode(data[3 * S + 17:], final=True))
        outs.append((enc.comp_lens, enc.out_lens))
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert zlib.decompressobj(-15, zdict=d).decompress(outs[0]) == data


# ---------------------------------------------------------------------------
# the single-program encode: one CUDA graph a batch (device/graphs.py)
# ---------------------------------------------------------------------------

def _graph_batch(cuda, level, B=4, seed=0):
    """A batch of B mixed shards on the card, primed from a carry, the
    last row ragged and final: encode_batch's arguments and knobs."""
    data = np.frombuffer(corpus("mixed", CTX + B * S, seed=seed), np.uint8)
    shards = torch.from_numpy(data[CTX:].reshape(B, S).copy()).to(cuda)
    ctx0 = torch.from_numpy(data[:CTX].copy()).to(cuda)
    ctx_lens = torch.full((B,), CTX, dtype=torch.int32, device=cuda)
    valid = torch.full((B,), S, dtype=torch.int32, device=cuda)
    valid[-1] = S - 777
    finals = torch.zeros(B, dtype=torch.int32, device=cuda)
    finals[-1] = 1
    return ((shards, ctx0, ctx_lens, valid, finals),
            dict(S=S, ctx=CTX, **pipeline2.level_params(level, S)))


def _eager_core(args, kn):
    windows = pipeline2._prime_windows(args[0], args[1], CTX)
    return pipeline2.encode_core(windows, *args[2:], **kn)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_graph_replay_equal_eager(cuda, level):
    """encode_batch's replays (the first call captures) equal the eager
    encode_core on the same batch, and on a second batch written into the
    same graph."""
    graphs.clear()
    for seed in (0, 1, 1):
        args, kn = _graph_batch(cuda, level, seed=seed)
        want = _eager_core(args, kn)
        got = pipeline2.encode_batch(*args, **kn)
        for a, b in zip(got, want):
            _eq(a, b)
    assert len(graphs._GRAPHS) == 1


def test_graph_launch_counts(cuda):
    """LAUNCHES after N replays is N x one eager batch's counts: the
    capture adds nothing, a replay adds what the capture recorded."""
    graphs.clear()
    args, kn = _graph_batch(cuda, 6)
    _build.LAUNCHES.clear()
    _eager_core(args, kn)
    eager = dict(_build.LAUNCHES)
    assert eager.get("flate_matcher", 0) == 1
    _build.LAUNCHES.clear()
    pipeline2.encode_batch(*args, **kn)     # warm-up (eager), then a replay
    assert dict(_build.LAUNCHES) == {k: 2 * v for k, v in eager.items()}
    (g,) = graphs._GRAPHS.values()
    assert dict(g.launches) == eager
    _build.LAUNCHES.clear()
    for _ in range(3):
        pipeline2.encode_batch(*args, **kn)
    assert dict(_build.LAUNCHES) == {k: 3 * v for k, v in eager.items()}
    assert g.replays == 4


def test_second_key_captures_its_own_graph(cuda):
    """Levels 1 and 6 hold a graph each in the one pool; replays of the
    two in turns stay right."""
    graphs.clear()
    for level in (1, 6, 1, 6):
        args, kn = _graph_batch(cuda, level, seed=level)
        for a, b in zip(pipeline2.encode_batch(*args, **kn),
                        _eager_core(args, kn)):
            _eq(a, b)
    assert len(graphs._GRAPHS) == 2


@pytest.mark.parametrize("container", ["GZIP", "ZLIB"])
def test_fused_loop_equal_staged(cuda, container):
    """Three batches through the fused loop, two in flight, equal the
    staged bytes on the card and on the CPU."""
    data = corpus("mixed", 11 * S + 99, seed=4)
    kw = dict(level=6, container=Container[container], shard_len=S,
              ctx=CTX, batch=4)
    fused = pipeline2.compress_device2(data, fused=True, **kw)
    assert fused == pipeline2.compress_device2(data, **kw)
    assert fused == pipeline2.compress_device2(data, device="cpu", **kw)
    assert zlib.decompress(fused, 31 if container == "GZIP" else 15) == data


def test_checksums_on_the_card(cuda):
    data = corpus("mixed", (1 << 20) + 4097, seed=6)
    assert checksum.crc32_device(data) == zlib.crc32(data)
    assert checksum.adler32_device(data) == zlib.adler32(data)


SCAN_CASES = scan_cases()


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scan_kernel_equal_plain(cuda, name):
    """scan_kernel (S1) against the plain scanner on the CPU cases, and
    chunk_entries at 32 KiB and 5,001-byte chunks.  scan_headers launches
    once a header, and once more where fewer than max_out are left."""
    data, start, end, max_out = SCAN_CASES[name]
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.zeros(0, dtype=torch.uint8)
    _build.LAUNCHES.clear()
    got = scan.scan_headers(buf.to(cuda), start, end, max_out)
    assert got == scan.scan_headers(buf, start, end, max_out)
    lo, hi = scan._range(len(data), start, end)
    rest = (got[-1] + 1 if got else lo) < hi and len(got) < max_out
    assert _build.LAUNCHES["flate_scan_headers"] == len(got) + rest
    for chunk in (32768, 5001):
        assert scan.chunk_entries(buf.to(cuda), chunk) == \
            scan.chunk_entries(buf, chunk)


def test_scan_kernel_every_offset(cuda):
    """Every header of a body with many headers (level 1, 2 MiB of mixed
    data; max_out never reached, so launches run to the end) against the
    plain scan of every offset."""
    body = zlib.compress(corpus("mixed", 2 << 20, seed=9), 1)[2:-4]
    buf = torch.frombuffer(bytearray(body), dtype=torch.uint8)
    lo, hi = scan._range(len(body), 5, None)
    want = scan._scan_plain(scan._prepare(buf), lo, hi, 1 << 30)
    got = scan.scan_headers(buf.to(cuda), 5, None, 1 << 30)
    assert got == want and len(want) > 10


def test_scan_kernel_chunk_entries_full_width(cuda):
    """chunk_entries at the decode's 512 KiB chunks on a 12 MiB level-6
    mixed body, one launch."""
    body = zlib.compress(corpus("mixed", 24 << 20, seed=2), 6)[2:]
    buf = torch.frombuffer(bytearray(body), dtype=torch.uint8)
    _build.LAUNCHES.clear()
    got = scan.chunk_entries(buf.to(cuda), anyinflate.CHUNK_BYTES)
    assert _build.LAUNCHES["flate_scan_headers"] == 1
    assert got == scan.chunk_entries(buf, anyinflate.CHUNK_BYTES)
    assert len(got) > 2


@pytest.mark.parametrize("case", ["text", "trap", "mixed_default_chunk"])
def test_decompress_any_chunked_cuda_equal_cpu(cuda, case):
    """The chained decode with scanned entries: card bytes and chain heads
    equal the CPU's."""
    if case == "text":
        blob, chunk = zlib.compress(corpus("text", 400_000), 6), 32768
    elif case == "trap":
        blob, chunk = trap_stream(), 32768
    else:
        blob = zlib.compress(corpus("mixed", 3 << 20, seed=6), 6)
        chunk = anyinflate.CHUNK_BYTES
    heads = []
    outs = []
    for dev in (cuda, "cpu"):
        inflate2.STATS.clear()
        _build.LAUNCHES.clear()
        outs.append(anyinflate.decompress_device_any(
            blob, Container.ZLIB, chunk_bytes=chunk, device=dev))
        heads.append(inflate2.STATS["chain_heads"])
        if dev == cuda:
            assert _build.LAUNCHES["flate_scan_headers"] == 1
    assert outs[0] == outs[1] == zlib.decompress(blob)
    assert heads[0] == heads[1] > 1


def test_scan_wrapper_rejects_bad_tensors(cuda):
    with pytest.raises(ValueError):
        scan.scan_headers(torch.zeros(400, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        scan._scan_cuda(torch.zeros((400, 2), dtype=torch.uint8,
                                    device=cuda)[:, 0], 0, 100, 100, 1)


BIG_BLOCKS = big_block_streams()


@pytest.mark.parametrize("name", list(BIG_BLOCKS))
def test_big_blocks_cuda_equal_cpu(cuda, name):
    """Blocks of more than 4 MiB of output (resolved in rows cut at symbol
    boundaries) and of more symbols than twice their compressed bytes (a
    symbol slot a bit of the span): the card's bytes equal the CPU's and
    zlib's, through a walk kernel."""
    container, blob = BIG_BLOCKS[name]
    ns = getattr(api, container.lower())
    _build.LAUNCHES.clear()
    got = ns.decompress(blob)
    walks = _build.LAUNCHES["flate_lane_walk"] + _build.LAUNCHES["flate_walk"]
    want = zlib.decompress(blob, 31 if container == "GZIP" else 15)
    assert got == want == ns.decompress(blob, device="cpu")
    assert walks > 0


@pytest.mark.parametrize("name", ["huffman_12mib_text",
                                  "level1_6mib_one_block"])
def test_long_blocks_cuda_equal_cpu(cuda, monkeypatch, name):
    """Blocks longer than MAX_SPAN, cut to 64 KiB (164 and 183 KB blocks of
    the port's host writer): continuation rows on the card, through a walk
    kernel, give the CPU's bytes and the input."""
    monkeypatch.setattr(anyinflate, "MAX_SPAN", 1 << 16)
    monkeypatch.setattr(anyinflate, "SPAN0", 1 << 14)
    container, blob, data = long_block_streams()[name]
    ns = getattr(api, container.lower())
    _build.LAUNCHES.clear()
    inflate2.STATS.clear()
    got = ns.decompress(blob)
    walks = _build.LAUNCHES["flate_lane_walk"] + _build.LAUNCHES["flate_walk"]
    conts = inflate2.STATS["continuation_rows"]
    assert got == data == ns.decompress(blob, device="cpu")
    assert walks > 0 and conts >= 2


@pytest.mark.parametrize("level", [1, 4, 6, 9])
def test_round1_cuda_bytes_equal_cpu(cuda, level):
    """The round-1 encoder (device/pipeline.compress_device) on the card:
    the CPU's bytes, with B3, B4, B9 and B5 launched once a batch; and its
    matcher's outputs equal on both devices."""
    from flate_tpu_torch.device import match as r1match
    from flate_tpu_torch.device import pipeline as r1
    data = corpus("mixed", 5 * S + 777, seed=level)
    kw = dict(level=level, shard_len=S, ctx=S, batch=2)
    cpu = r1.compress_device(data, device="cpu", **kw)
    _build.LAUNCHES.clear()
    got = r1.compress_device(data, **kw)
    assert got == cpu
    assert zlib.decompress(got, 31) == data
    for name in ("flate_small_runs", "flate_extend", "flate_parse_walk",
                 "flate_pack"):
        assert _build.LAUNCHES[name] == 3, name
    win = torch.from_numpy(windows("text", seed=level))
    cl = torch.tensor([0, CTX], dtype=torch.int32)
    knobs = r1.level_knobs(level)
    for a, b in zip(r1match.find_matches_device(
            win.to(cuda), cl.to(cuda), K=knobs["K"], K3=knobs["K3"],
            ctx=CTX, nwords=knobs["nwords"]),
            r1match.find_matches_device(
            win, cl, K=knobs["K"], K3=knobs["K3"], ctx=CTX,
            nwords=knobs["nwords"])):
        _eq(a, b)


class _SmallWindow(api.Decompressor):
    WINDOW = 16384
    FETCH = 5000
    TRIM = 32768


def _stream_read(blob: bytes, container: Container, device, n: int,
                 dictionary=None, cls=_SmallWindow) -> bytes:
    d = cls(blob, container, dictionary=dictionary, device=device)
    parts = []
    while chunk := d.read(n):
        parts.append(chunk)
    return b"".join(parts)


@pytest.mark.parametrize("case", ["small_blocks", "level6", "own_gzip",
                                  "stored"])
def test_decompressor_cuda_equal_cpu(cuda, case):
    """The streaming Decompressor at a 16 KiB window on the card: the
    CPU's bytes, with the scanner and a walk kernel launched."""
    data = corpus("mixed", 200_000, seed=61)
    container = Container.ZLIB
    if case == "small_blocks":
        blob = small_blocks(data)
    elif case == "level6":
        blob = zlib.compress(data, 6)
    elif case == "own_gzip":
        blob, container = api.gzip.compress(data, 6, shard_len=S), \
            Container.GZIP
    else:
        c = zlib.compressobj(0)
        blob = b"".join(c.compress(data[i:i + 20000]) + c.flush(
            zlib.Z_FULL_FLUSH) for i in range(0, len(data), 20000)) \
            + c.flush()
    _build.LAUNCHES.clear()
    got = _stream_read(blob, container, cuda, 7777)
    walks = _build.LAUNCHES["flate_lane_walk"] + _build.LAUNCHES["flate_walk"]
    assert got == data == _stream_read(blob, container, "cpu", 7777)
    if case != "stored":
        assert walks > 0
    if case in ("small_blocks", "level6"):
        assert _build.LAUNCHES["flate_scan_headers"] > 0


def test_dictionary_cuda_equal_cpu(cuda):
    d = corpus("text", 40_000, seed=62)
    data = corpus("text", 150_000, seed=63)
    c = zlib.compressobj(6, zdict=d)
    blob = c.compress(data) + c.flush()
    got = api.zlib.decompress(blob, dictionary=d)
    assert got == data == api.zlib.decompress(blob, dictionary=d,
                                              device="cpu")
    assert _stream_read(blob, Container.ZLIB, cuda, 50_000, d) == data


@pytest.mark.parametrize("container", ["RAW", "ZLIB"])
def test_too_far_back_raises_on_cuda(cuda, container):
    from flate_tpu_torch import errors
    ns = api.flate if container == "RAW" else api.zlib
    with pytest.raises(errors.InvalidMatch):
        ns.decompress(too_far_streams()[container])


@pytest.mark.parametrize("mode", ["huffman", "store"])
def test_sub_modes_decode_on_cuda(cuda, mode):
    data = corpus("mixed", 300_000, seed=64)
    blob = getattr(api.gzip, mode).compress(data)
    assert api.gzip.decompress(blob) == data


def test_malformed_cuda_verdicts_equal_cpu(cuda):
    """The reference's 40 malformed streams (tests/data/fuzz) and 100 raw
    mutations (chip_smoke.py mutants over fuzz_seeds, the port's own raw
    member made on the card) through the one-shot and the streaming decode:
    the same bytes or error class on the card as on the CPU, the corpus
    also the table's.  The JAX package's verdicts are held on the CPU by
    tests/test_torch_malformed.py and tests/test_torch_mutation.py."""
    import io
    import chip_smoke as cs
    cases = []
    for name, expect, cls in cs.FUZZ_CASES:
        data, expect = cs.fuzz_case(name, expect)
        cases.append((name, data, (expect, cls)))
    seeds = cs.fuzz_seeds("RAW", cs.own_member("RAW", cuda))
    cases += [(f"mutation {i}", d, None)
              for i, d in enumerate(cs.mutants(seeds, 100))]
    bad = []
    for name, data, want in cases:
        got = {}
        for dev in (cuda, "cpu"):
            got[dev] = (
                cs.verdict(lambda: api.flate.decompress(data, device=dev)),
                cs.verdict(lambda: api.flate.decompressor(
                    io.BytesIO(data), device=dev).read_all()))
        if got[cuda] != got["cpu"] or (want and got["cpu"] != (want, want)):
            bad.append(name)
    assert not bad, bad
