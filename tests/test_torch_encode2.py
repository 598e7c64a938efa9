"""Port field build (onehot, huff, header, encode2.build_fields) against
the JAX package on the outputs of real parses, and the compact grid of
tools/torch_kernel_probe.py (`slot_count_compact`, `compact`: the port's
full grid compacted) against the JAX build_fields(compact=True).
Tolerance: exact (u32 values compared as uint32)."""

import functools
import importlib.util
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu.jx import encode2 as j_encode2
from flate_tpu.jx import header as j_header
from flate_tpu.jx import huff as j_huff
from flate_tpu.jx import match2 as j_match2
from flate_tpu.jx import onehot as j_onehot
from flate_tpu.jx import parse as j_parse

from flate_tpu_torch.device import encode2, header, huff, onehot, pack

from _torch_corpora import CTX, KINDS, S, rfc_text, tt, u32, windows
from _torch_estimate_ties import fields, margins, tie_shard


def _hists(seed, B=6, n=286):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 5000, (B, n)) * (rng.random((B, n)) < 0.4)
    h[0] = 0                        # no symbol
    h[1] = 0
    h[1, 7] = 3                     # one symbol
    h[2] = 0
    h[2, [3, n - 1]] = [1, 100000]  # two, skewed
    h[3] = rng.integers(1, 200000, n)   # every symbol, deep tree
    return h.astype(np.int32)


@pytest.mark.parametrize("n,max_bits", [(286, 15), (30, 15), (19, 7)])
def test_pm_lengths_and_codes_equal(n, max_bits):
    h = _hists(n, n=n)
    jl = np.asarray(j_huff.pm_lengths(jnp.asarray(h), max_bits))
    tl = huff.pm_lengths(tt(h), max_bits)
    np.testing.assert_array_equal(tl.numpy(), jl)
    jc = j_huff.canonical_codes_dev(jnp.asarray(jl), max_bits)
    tc = huff.canonical_codes_dev(tl, max_bits)
    np.testing.assert_array_equal(u32(tc), u32(jc))
    np.testing.assert_array_equal(
        huff.coded_size(tt(h), tl).numpy(),
        np.asarray(j_huff.coded_size(jnp.asarray(h), jnp.asarray(jl))))


@pytest.mark.parametrize("n,max_bits", [(286, 15), (30, 15), (19, 7)])
def test_packed_tables_equal(n, max_bits):
    jl = j_huff.pm_lengths(jnp.asarray(_hists(n + 1, n=n)), max_bits)
    np.testing.assert_array_equal(
        u32(huff.packed_tables(tt(np.asarray(jl)), max_bits)),
        u32(j_huff.packed_tables(jl, max_bits)))


def test_build_headers_equal():
    hl = _hists(1)
    hd = _hists(2, n=30)
    ll = np.asarray(j_huff.pm_lengths(jnp.asarray(hl), 15))
    dl = np.array(j_huff.pm_lengths(jnp.asarray(hd), 15))
    dl[dl.sum(axis=1) == 0, 0] = 1
    final = np.asarray([0, 1, 0, 1, 0, 0], np.int32)
    jv, jb, jt = j_header.build_headers(jnp.asarray(ll), jnp.asarray(dl),
                                        jnp.asarray(final))
    tv, tb, tt_ = header.build_headers(tt(ll), tt(dl), tt(final))
    np.testing.assert_array_equal(u32(tv), u32(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt))


def test_hist_and_lookup_equal():
    rng = np.random.default_rng(4)
    sym = rng.integers(0, 286, (3, 5000)).astype(np.int32)
    w = (rng.random((3, 5000)) < 0.7).astype(np.int32)
    np.testing.assert_array_equal(
        onehot.hist_onehot(tt(sym), tt(w), 286).numpy(),
        np.asarray(j_onehot.hist_onehot(jnp.asarray(sym), jnp.asarray(w),
                                        286)))
    tab = rng.integers(0, 2**32, (3, 286), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        u32(onehot.lookup_onehot(tt(tab.astype(np.int64)), tt(sym))),
        u32(j_onehot.lookup_onehot(jnp.asarray(tab), jnp.asarray(sym))))


def _parsed(win, ctx_len, valid, level_knobs=(12, 4), blk=1024):
    """The JAX parse of a window batch: (tail, m_r, d_r, starts_r, take_r)."""
    K, nw = level_knobs
    ml, md = j_match2.find_matches_fused(
        jnp.asarray(win), jnp.asarray(ctx_len), jnp.asarray(valid), K=K,
        nw=nw, ctx=CTX, interpret=True)
    ml, md = j_parse.truncate_matches(ml, md, CTX, blk)
    take, _ = j_parse.decide(ml, md, False, 0)
    starts = j_parse.parse_blocks(ml, md, start=CTX, lazy=False,
                                  max_lazy=0, blk=blk)
    return tuple(np.asarray(x)[:, CTX:] for x in
                 (win, ml, md, starts, take))


def _equal(t, j):
    """The port's (vals, bits, total_bits, kind) equal to the JAX ones."""
    assert t[0].dtype == torch.int32            # vals: the packer's width
    np.testing.assert_array_equal(u32(t[0]), u32(j[0]))     # vals
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


def _check_build(parts, valid, final, compact=False, seg=None):
    """The port's build_fields equal to the JAX one; returns the port's
    (vals, bits, total_bits, kind).  compact=True: the port's grid
    compacted by the probe's `compact`, equal to the JAX
    build_fields(compact=True)."""
    seg = seg or encode2.seg_size(S, 1024)
    j = j_encode2.build_fields(*(jnp.asarray(p) for p in parts),
                               jnp.asarray(valid), jnp.asarray(final), S,
                               seg, compact=compact)
    t = encode2.build_fields(*(tt(p) for p in parts), tt(valid), tt(final),
                             S, seg)
    if compact:
        t = (*_probe().compact(t[0], t[1], _slot_count_compact(S, seg)),
             *t[2:])
    _equal(t, j)
    return t


@functools.lru_cache(maxsize=None)
def _probe():
    """tools/torch_kernel_probe.py loaded as a module."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "torch_kernel_probe.py"
    spec = importlib.util.spec_from_file_location("torch_kernel_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slot_count_compact(S_, seg=None):
    return _probe().slot_count_compact(S_, seg or encode2.seg_size(S_),
                                       header.HDR_SLOTS)


VALID = np.asarray([S, 1800], np.int32)
FINAL = np.asarray([0, 1], np.int32)


@functools.lru_cache(maxsize=None)
def _kind_parts(kind):
    """The JAX parse of two rows of one corpus kind (row 0 with context,
    row 1 a final 1800-byte tail), made once a process."""
    return _parsed(windows(kind, seed=13), np.asarray([CTX, 0], np.int32),
                   VALID)


@pytest.mark.parametrize("kind", KINDS)
def test_build_fields_equal(kind):
    _check_build(_kind_parts(kind), VALID, FINAL)


@pytest.mark.parametrize("S_", [S, 1024, 7168, 1 << 17])
def test_slot_count_compact_equal(S_):
    for seg in (None, 1024, encode2.seg_size(S_)):
        assert _slot_count_compact(S_, seg) == \
            j_encode2.slot_count_compact(S_, seg)
        assert _slot_count_compact(S_, seg) < encode2.slot_count(S_, seg)


@pytest.mark.parametrize("kind", KINDS)
def test_build_fields_compact_equal(kind):
    """The port's grid compacted equals the JAX compact=True grid element
    for element (its sort on the keys idx | 2^20 for dead slots), and
    holds every live field of the full grid, in slot order."""
    comp = _check_build(_kind_parts(kind), VALID, FINAL, compact=True)
    full = _check_build(_kind_parts(kind), VALID, FINAL)
    assert comp[0].shape == (2, _slot_count_compact(S, 1024))
    for r in range(2):
        live = full[1][r] > 0
        n = int(live.sum())
        assert torch.equal(comp[1][r, :n], full[1][r][live])
        assert torch.equal(comp[0][r, :n], full[0][r][live])
        assert not comp[1][r, n:].any() and not comp[0][r, n:].any()


def _pack_equal(full, comp):
    """The compact grid packs to the full grid's words and total_bits;
    returns each row's stream bytes."""
    nwr = -(-int(full[2].max()) // (32 * 128)) + 1
    fw, ft = pack.pack_fields(full[0], full[1], nwr)
    cw, ct = pack.pack_fields(comp[0], comp[1], nwr)
    np.testing.assert_array_equal(cw.numpy(), fw.numpy())
    np.testing.assert_array_equal(ct.numpy(), ft.numpy())
    np.testing.assert_array_equal(ft.numpy(), full[2].numpy())
    return [cw[r].numpy().reshape(-1).astype("<i4").tobytes()[
        :int(ft[r]) // 8] for r in range(cw.shape[0])]


@pytest.mark.parametrize("kind", KINDS)
def test_compact_grid_packs_to_full_grid(kind):
    parts = _kind_parts(kind)
    full = _check_build(parts, VALID, FINAL)
    comp = _check_build(parts, VALID, FINAL, compact=True)
    raw = _pack_equal(full, comp)[1]         # row 1: no context, final
    assert zlib.decompress(raw, -15) == parts[0][1, :VALID[1]].tobytes()


@pytest.mark.parametrize("n", [20, 47, 147, 301])
def test_build_fields_fixed_blocks_high_literals(n):
    """Tiny incompressible inputs pick fixed (or stored) blocks, and bytes
    >= 144 use the 9-bit fixed literal codes (the full 288-symbol
    assignment)."""
    rng = np.random.default_rng(1234 + n)
    win = np.zeros((2, CTX + S), np.uint8)
    win[0, CTX:CTX + n] = rng.integers(128, 256, n, dtype=np.uint8)
    win[1, CTX:CTX + n] = rng.integers(0, 256, n, dtype=np.uint8)
    valid = np.asarray([n, n], np.int32)
    kind = _check_build(_parsed(win, np.zeros(2, np.int32), valid, (4, 2)),
                        valid, np.asarray([1, 1], np.int32))[3].numpy()
    if n == 20:
        assert kind[0] == encode2.KIND_FIX


def test_entropy_bits_close():
    """The float32 stored/coded estimate uses the same formula.  torch's
    and XLA's float32 log2 differ in the last bit on some inputs, so the
    tolerance is 2 ulp (rtol 2**-22); the decisions built on it are held
    exactly by test_build_fields_equal and the end-to-end tests."""
    h = _hists(9)
    np.testing.assert_allclose(
        encode2._entropy_bits(torch.from_numpy(h)).numpy(),
        np.asarray(j_encode2._entropy_bits(jnp.asarray(h))),
        rtol=2.0 ** -22, atol=0)


# ---------------------------------------------------------------------------
# the compact grid's bound: inputs that push the live field count up
# ---------------------------------------------------------------------------

ADV_VALID = np.asarray([S, S - 333], np.int32)
ADV_FINAL = np.asarray([0, 1], np.int32)


def _alternating_tail(seg, first_random, seed):
    """S bytes whose segments alternate seeded random bytes and seeded
    letters of a 16-letter alphabet.  The letters make the random bytes'
    symbols rare, so those segments go stored and the letter segments
    coded: a coded block opens in every other segment."""
    rng = np.random.default_rng(seed)
    rnd = rng.integers(0, 256, S, dtype=np.uint8)
    letters = rng.integers(97, 97 + 16, S, dtype=np.uint8)
    row = letters.copy()
    for j, lo in enumerate(range(0, S, seg)):
        if (j % 2 == 0) == first_random:
            row[lo:lo + seg] = rnd[lo:lo + seg]
    return row


def _alternating_real(seg):
    """The JAX parse (parse blocks of one segment) of two alternating
    rows, one opening with random bytes, the other with letters."""
    win = np.zeros((2, CTX + S), np.uint8)
    for r in range(2):
        win[r, CTX:] = _alternating_tail(seg, r == 0, seed=21 + r)
    win[0, :CTX] = np.frombuffer(rfc_text()[:CTX], np.uint8)
    return _parsed(win, np.asarray([CTX, 0], np.int32), ADV_VALID, blk=seg)


def _literal_parse(tails):
    """Every position a literal token start."""
    B = len(tails)
    zero = np.zeros((B, S), np.int32)
    return (np.stack(tails), zero, zero, np.ones((B, S), bool),
            np.zeros((B, S), bool))


def _all_literals(seg):
    """All-literal parses of an alternating row and a text row (coded
    literals in every segment)."""
    text = np.frombuffer(rfc_text()[:S], np.uint8)
    return _literal_parse([_alternating_tail(seg, False, 3), text])


def _length3_only(seg, period=509):
    """Rows of `period` seeded random bytes repeated, parsed into matches
    of exactly 3 bytes at seeded multiples of the period (valid copies),
    none crossing a segment or the row's end: the first period bytes, and
    the last seg % 3 of a segment, literals.  The random bytes make
    literals dear, so the rows code the matches (two live fields a
    match)."""
    rng = np.random.default_rng(seg)
    rows, mlen, mdist, starts, take = [], [], [], [], []
    for n in ADV_VALID:
        row = np.resize(rng.integers(0, 256, period, dtype=np.uint8), S)
        st = np.ones(S, bool)
        tk = np.zeros(S, bool)
        for lo in range(0, n, seg):
            for p in range(max(lo, period), min(lo + seg, n) - 2, 3):
                tk[p] = True
                st[p + 1:p + 3] = False
        d = period * rng.integers(1, np.maximum(np.arange(S) // period, 1)
                                  + 1)
        rows.append(row)
        mlen.append(np.where(tk, 3, 0))
        mdist.append(np.where(tk, d, 0))
        starts.append(st)
        take.append(tk)
    return (np.stack(rows), np.stack(mlen).astype(np.int32),
            np.stack(mdist).astype(np.int32), np.stack(starts),
            np.stack(take))


ADVERSARIAL = {"alternating": _alternating_real, "literals": _all_literals,
               "length3": _length3_only}


def _openings(bits, seg):
    """Block openings a row: segments whose header slots hold a live
    field (the full grid's layout: per segment 4 boundary slots, the
    header's, then two a position)."""
    ns = -(-S // seg)
    stride = 4 + header.HDR_SLOTS + 2 * seg
    return sum((bits[:, j * stride + 4:j * stride + 4 + header.HDR_SLOTS]
                > 0).any(axis=1) for j in range(ns))


@pytest.mark.parametrize("seg", [256, 1024])
@pytest.mark.parametrize("case", list(ADVERSARIAL))
def test_compact_bound_holds(case, seg):
    """The live fields of a row fit slot_count_compact in both packages
    (the JAX compaction keeps every live field), on segments that
    alternate stored and coded (the most openings), all-literal rows (a
    live field a byte) and rows of length-3 matches only; the port's grid
    compacted equals the JAX compact grid and packs to the full grid's
    stream, which zlib decodes to the row."""
    parts = ADVERSARIAL[case](seg)
    valid, final = ADV_VALID, ADV_FINAL
    SC = _slot_count_compact(S, seg)
    args = (*(jnp.asarray(p) for p in parts), jnp.asarray(valid),
            jnp.asarray(final), S, seg)
    j_live = (np.asarray(j_encode2.build_fields(*args)[1]) > 0).sum(axis=1)
    j_kept = (np.asarray(j_encode2.build_fields(*args, compact=True)[1])
              > 0).sum(axis=1)
    full = _check_build(parts, valid, final, seg=seg)
    comp = _check_build(parts, valid, final, compact=True, seg=seg)
    live = (full[1] > 0).sum(dim=1).numpy()
    np.testing.assert_array_equal(live, j_live)
    assert live.max() <= SC, (live, SC)
    np.testing.assert_array_equal(j_kept, j_live)
    np.testing.assert_array_equal((comp[1] > 0).sum(dim=1).numpy(), live)
    if case == "literals":
        # a live field a byte: the body term of the bound is reached
        assert live.min() >= valid.min()
    if case == "length3":
        assert (comp[3] == encode2.KIND_DYN).all()
    if case == "alternating":
        assert _openings(full[1].numpy(), seg).max() >= -(-S // seg) // 2
    raws = _pack_equal(full, comp)
    if case != "alternating":                # row 0 there has context
        assert zlib.decompressobj(-15).decompress(raws[0]) == \
            parts[0][0].tobytes()
    assert zlib.decompress(raws[1], -15) == parts[0][1, :valid[1]].tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coded_est_symbol_order_invariant(seed):
    """The stored/coded estimate (encode2._coded_est) and the decision
    built on it are bit for bit the same under any permutation of the
    symbol axes, and equal the exact sum rounded once to float32: segment
    histograms of up to 65,535 tokens, and segments placed a few ulp
    around the threshold 8 * live + 40 + 192 so the decision is close."""
    rng = np.random.default_rng(seed)
    B, nseg = 3, 12
    hll = rng.integers(0, 400, (B, nseg, 286)) * (
        rng.random((B, nseg, 286)) < 0.3)
    hll[0, 0, 65] = 65535 - hll[0, 0].sum() + hll[0, 0, 65]
    hdd = rng.integers(0, 200, (B, nseg, 30)) * (
        rng.random((B, nseg, 30)) < 0.5)
    extras = rng.integers(0, 3000, (B, nseg))
    hll_t, hdd_t, ex_t = (torch.from_numpy(x) for x in (hll, hdd, extras))
    est = encode2._coded_est(hll_t, hdd_t, ex_t)
    assert est.dtype == torch.float32
    ll = encode2._entropy_bits(hll_t.sum(dim=1)).numpy().astype(np.float64)
    dd = encode2._entropy_bits(hdd_t.sum(dim=1)).numpy().astype(np.float64)
    exact = ((hll * ll[:, None, :]).sum(axis=2)
             + (hdd * dd[:, None, :]).sum(axis=2) + extras)
    np.testing.assert_array_equal(est.numpy(), exact.astype(np.float32))
    # live byte counts that put the threshold within a few bits of each
    # estimate: every segment a near tie
    live = torch.from_numpy(np.floor(
        (exact - 40 - encode2._HYST + rng.integers(-2, 3, (B, nseg))) / 8)
        .astype(np.int64))

    def want_stored(e):
        return e > (8 * live + 40).to(torch.float32) + encode2._HYST

    want = want_stored(est)
    assert want.any() and not want.all()
    for _ in range(4):
        pl, pd = rng.permutation(286), rng.permutation(30)
        e2 = encode2._coded_est(hll_t[:, :, pl], hdd_t[:, :, pd], ex_t)
        assert torch.equal(e2.view(torch.int32), est.view(torch.int32))
        assert torch.equal(want_stored(e2), want)


@pytest.mark.parametrize("index, jax_batch", [(649, 2), (2970, 1)])
def test_estimate_near_tie_follows_the_shard(index, jax_batch):
    """A literal-only shard with a segment's coded estimate within 0.01
    bits of the stored/coded threshold (tests/_torch_estimate_ties.py
    tie_shard(3, index)).  The jitted JAX build_fields gives it other
    fields alone than in a batch of two (its float32 einsum sums in another
    order), so no rule of the shard alone can give both (ROADMAP C.18).
    The port gives the same fields alone and in a batch: the JAX package's
    fields in a batch of `jax_batch` rows."""
    row = tie_shard(3, index)[None, :]
    two = np.concatenate([row, np.zeros_like(row)])
    assert np.abs(margins(row)).min() < 0.01
    j1, j2 = fields(row, True), fields(two, True)
    assert j1[1][0] != j2[1][0]
    want = (j1, j2)[jax_batch - 1]
    for got in (fields(row, False), fields(two, False)):
        np.testing.assert_array_equal(got[0][0], want[0][0])
        assert got[1][0] == want[1][0]
