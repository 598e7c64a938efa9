"""Port device/inflate2.py against flate_tpu/jx/inflate2.py on the CPU.

The same numbers (made with numpy from the JAX package's pack_coded_run)
go through every stage on both sides; the JAX side runs its Pallas kernels
in interpret mode.  Tolerance: exact (integers and bytes), words compared
as uint32 and, past a compaction, only below `counts`.
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu import inflate as j_hinf
from flate_tpu import tables as j_tables
from flate_tpu.jx import inflate2 as j_i2

import flate_tpu_torch as ftt
from flate_tpu_torch import errors
from flate_tpu_torch import inflate as hinf
from flate_tpu_torch.device import inflate2 as i2

from _torch_corpora import lane_edge_rows, tt, u32, walk_edge_rows
from _torch_decode_ref import (BATCH, CTX, S, coded_run, gz, inputs,
                               jax_blob, port_blob, shards_of, text)

NS = S + 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain walks are thousands of tiny tensor ops: one intra-op thread
    runs them faster, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# the member streams the stage tests take their shards from
STREAMS = {"jax_l1": lambda: jax_blob("text", 1),
           "jax_l6": lambda: jax_blob("text", 6),
           "port_l3": lambda: port_blob("text", 3)}


def _args(stream: str):
    """(numpy args of the JAX package, the port's tensors) of one stream's
    leading coded shards."""
    a = coded_run(STREAMS[stream]())
    return a, i2.args_from_numpy(a, "cpu")


def _j(a):
    return [jnp.asarray(x) for x in a]


def _fixed_args():
    """One shard of fixed-Huffman blocks (zlib's Z_FIXED strategy), packed
    by both sides' planners."""
    data = text(3000)
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    sh = c.compress(data) + c.flush()
    ja = tuple(np.asarray(x) for x in j_i2.pack_coded_run(
        [(j_i2.plan_shard(sh, len(data)), sh)], b""))
    ta = i2.pack_coded_run([(i2.plan_shard(sh, len(data)), sh)], b"")
    return ja, ta


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_canonical_scalars_equal(seed):
    rng = np.random.default_rng(seed)
    if seed == 0:
        lens, n = np.asarray(j_tables.FIXED_LITLEN_LENS), 288
    elif seed == 1:
        lens, n = np.asarray(j_tables.FIXED_DIST_LENS), 32
    else:
        lens = rng.integers(0, 16, 286 if seed == 2 else 30)
        n = 288 if seed == 2 else 32
    for a, b in zip(i2.canonical_scalars(lens, n),
                    j_i2.canonical_scalars(lens, n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _plans_equal(p, q):
    assert p.kind == q.kind and p.out_len == q.out_len and p.final == q.final
    assert p.stored_spans == q.stored_spans
    if p.kind == "coded":
        assert p.start_bit == q.start_bit
        for a, b in zip(p.ll + p.d, q.ll + q.d):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kind", [("text", "coded"), ("random", "stored"),
                                       ("segmented", None)])
def test_plan_shard_equal(name, kind):
    kinds = set()
    for sh, out_len in shards_of(port_blob(name, 3)):
        p, q = i2.plan_shard(sh, out_len), j_i2.plan_shard(sh, out_len)
        _plans_equal(p, q)
        kinds.add(p.kind)
    if kind is not None:
        assert kinds == {kind}
    else:                                # stored-then-coded shards exist
        assert "mixed" in kinds or "coded" in kinds


def test_plan_shard_mixed_and_errors():
    rng = np.random.default_rng(1)
    noise = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    sh = c.compress(noise) + c.flush(zlib.Z_FULL_FLUSH) \
        + c.compress(text(3000)) + c.flush()
    p, q = i2.plan_shard(sh, 6000), j_i2.plan_shard(sh, 6000)
    assert p.kind == q.kind == "mixed"
    with pytest.raises(errors.InvalidBlockType):
        i2.plan_shard(b"\x07\x00\x00", 10)
    with pytest.raises(errors.WrongStoredBlockNlen):
        i2.plan_shard(b"\x01\x05\x00\x00\x00abcde", 5)


@pytest.mark.parametrize("stream", list(STREAMS))
def test_pack_coded_run_equal(stream):
    blob = STREAMS[stream]()
    hist = text(700)
    run_j, run_t = [], []
    for sh, out_len in shards_of(blob):
        run_j.append((j_i2.plan_shard(sh, out_len), sh))
        run_t.append((i2.plan_shard(sh, out_len), sh))
    ja = j_i2.pack_coded_run(run_j, hist)
    ta = i2.pack_coded_run(run_t, hist, "cpu")
    assert len(ja) == len(ta) == 11
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(u32(b), u32(np.asarray(a)))
    # and the converter gives the packer's own tensors
    for a, b in zip(i2.args_from_numpy([np.asarray(x) for x in ja], "cpu"),
                    ta):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_host_decode_shard_equal():
    hist = text(900)
    data = text(5000)[900:]
    c = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=hist)
    sh = c.compress(data) + c.flush(zlib.Z_SYNC_FLUSH)
    assert i2._host_decode_shard(sh, len(data), hist) == data
    assert j_i2._host_decode_shard(sh, len(data), hist) == data
    for a, b in zip(hinf.fixed_tables(), j_hinf.fixed_tables()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# pass 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", list(STREAMS) + ["fixed"])
def test_pass1_equal(stream):
    ja, ta = _fixed_args() if stream == "fixed" else _args(stream)
    jw = np.asarray(j_i2._pass1(*_j(ja[:1] + ja[3:9])))
    tw = i2._pass1(ta[0], *ta[3:9])
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(u32(tw), jw)


def test_bit_windows_equal():
    rng = np.random.default_rng(5)
    comp = rng.integers(0, 256, (2, 1024), dtype=np.uint8)
    comp[:, :8] = 0xFF                   # windows with the top bit set
    np.testing.assert_array_equal(
        u32(i2._bit_windows32(tt(comp))),
        np.asarray(j_i2._bit_windows32(jnp.asarray(comp))))


# ---------------------------------------------------------------------------
# the two walks
# ---------------------------------------------------------------------------

def _word(stream):
    ja, ta = _args(stream)
    return ja, ta, i2._pass1(ta[0], *ta[3:9])


@pytest.mark.parametrize("G,J", [(256, 96), (512, 2), (256, 1)])
@pytest.mark.parametrize("where", ["true", "lane0", "later"])
@pytest.mark.parametrize("stream", ["jax_l1", "jax_l6"])
def test_lane_walk_plain_equal(stream, where, G, J):
    """Starts in lane 0 and in later lanes; the padded rows end in lanes
    past the stream; J of 1 or 2 forces join failures."""
    ja, ta, word = _word(stream)
    start = {"true": ja[2], "lane0": np.full_like(ja[2], 3),
             "later": np.full_like(ja[2], 2 * G + 17)}[where]
    nbits = 8 * ja[1]
    jm, jj = j_i2._lane_walk(jnp.asarray(u32(word)), jnp.asarray(start),
                             jnp.asarray(nbits), G=G, J=J, interpret=True)
    tm, tj = i2._lane_walk(word, tt(start), tt(nbits), G=G, J=J)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    if J <= 2:
        assert not np.asarray(jj).all()
    else:
        assert np.asarray(jj).mean() > 0.9


@pytest.mark.parametrize("G,NL,J", [(256, 3, 96), (256, 17, 96), (128, 17, 2),
                                    (512, 3, 1), (256, 1, 96)])
def test_lane_walk_edges_equal(G, NL, J):
    """Synthetic rows (tests/_torch_corpora.py lane_edge_rows): chains that
    leave every lane 0..62 positions past its end, random advances, start
    inside a symbol, in lane 1, in the last lane and past nbits, nbits
    mid-lane and 0; NL of 1, 3 and 17, J of 1 and 2 (joins that fail)."""
    word, start, nbits = lane_edge_rows(G, NL, seed=G + NL)
    jm, jj = j_i2._lane_walk(jnp.asarray(u32(word)), jnp.asarray(start),
                             jnp.asarray(nbits), G=G, J=J, interpret=True)
    tm, tj = i2._lane_walk(tt(word), tt(start), tt(nbits), G=G, J=J)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    assert not tm.numpy()[5].any() and not tm.numpy()[4].any()


@pytest.mark.parametrize("B,NL,G,want", [
    (8, 256, 2048, (4, True)),        # the indexed decode's batch
    (64, 256, 2048, (8, True)),       # a chained-route row chunk
    (2, 3, 256, (1, True)),
    (6, 3, 92928, (1, True)),         # the widest lane that stages
    (6, 3, 93056, (1, False)),        # walks device memory
    (64, 256, 32768, (4, True))])     # 9 lanes of 32 K do not fit
def test_lanes_per_block(B, NL, G, want):
    """The lane-walk kernel's lanes a block (up to 8, at least two blocks
    an SM on 132 SMs) and whether they stage in the 227 KiB of shared
    memory."""
    assert i2._lanes_per_block(B, NL, G, 132) == want
    L, staged = want
    assert (i2._lane_shared_bytes(L, G) <= i2.LANE_SMEM) == staged


def test_lane_walk_rejects_bad_widths():
    word = torch.zeros((1, 1024), dtype=torch.int32)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        i2._lane_walk(word, z, z, G=384)
    with pytest.raises(ValueError):
        i2._lane_walk(word, z, z, G=64)


def _walk_both(word, start, nbits, ns):
    jo, jc = j_i2._walk(jnp.asarray(u32(word)), jnp.asarray(start),
                        jnp.asarray(nbits), ns, True)
    to, tc = i2._walk(word, tt(start), tt(nbits), ns)
    jo, jc = np.asarray(jo), np.asarray(jc)
    np.testing.assert_array_equal(tc.numpy(), jc)
    for b in range(len(jc)):
        np.testing.assert_array_equal(u32(to[b, :jc[b]]), jo[b, :jc[b]])
    return jc


@pytest.mark.parametrize("stream", ["jax_l1", "jax_l6", "port_l3"])
def test_walk_plain_equal(stream):
    ja, _, word = _word(stream)
    jc = _walk_both(word, ja[2], 8 * ja[1], NS)
    assert (jc > 100).any()


def test_walk_plain_no_eob_and_full():
    ja, _, word = _word("jax_l6")
    whole = _walk_both(word, ja[2], 8 * ja[1], NS)
    nbits = 8 * ja[1]
    nbits[0] = 4000                      # row 0 ends before its EOB
    cut = _walk_both(word, ja[2], nbits, NS)
    assert cut[0] < whole[0] and (cut[1:] == whole[1:]).all()
    full = _walk_both(word, ja[2], 8 * ja[1], 128)   # rows that fill NS
    assert (full == 128).any()


@pytest.mark.parametrize("NS", [1152, 128])
def test_walk_plain_edge_rows(NS):
    """Synthetic rows whose chains cross chunk edges with adv 63, 1 and 0,
    an end-of-block word first, start == nbits, nbits > N, a run of
    one-bit steps and NS cutting the chain (tests/_torch_corpora.py
    walk_edge_rows; the CUDA kernel's rings hold 8192 words, here the edges
    fall every 256 words).  The JAX kernel reads past N when nbits > N, so
    it gets min(nbits, N), which is what the port's walk takes."""
    word, start, nbits = walk_edge_rows(1024, 256, seed=3)
    jo, jc = j_i2._walk(jnp.asarray(u32(word)), jnp.asarray(start),
                        jnp.asarray(np.minimum(nbits, 1024)), NS, True)
    to, tc = i2._walk(tt(word), tt(start), tt(nbits), NS)
    jo, jc = np.asarray(jo), np.asarray(jc)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(u32(to), jo)     # zero past the count
    assert jc[1] == 1 and jc[2] == 0 and jc[4] == NS
    assert NS == 128 or (jc[[0, 3, 5]] < NS).all()


# ---------------------------------------------------------------------------
# extract, propagate, resolve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("J", [96, 1])
@pytest.mark.parametrize("stream", ["jax_l1", "jax_l6"])
def test_extract_equal(stream, J):
    ja, ta, word = _word(stream)
    G = 256
    mask, joined = i2._lane_walk(word, ta[2], 8 * ta[1], G=G, J=J)
    jout = j_i2._extract(jnp.asarray(u32(word)), jnp.asarray(mask.numpy()),
                         jnp.asarray(joined.numpy()), jnp.asarray(ja[2]),
                         NS, G)
    tout = i2._extract(word, mask, joined, ta[2], NS, G)
    jw, jc, jfail, jeob = (np.asarray(x) for x in jout[:4])
    np.testing.assert_array_equal(tout[1].numpy(), jc)
    np.testing.assert_array_equal(tout[2].numpy(), jfail)
    np.testing.assert_array_equal(tout[3].numpy(), jeob)
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    for b in range(len(jc)):
        np.testing.assert_array_equal(u32(tout[0][b, :jc[b]]), jw[b, :jc[b]])
        if jeob[b]:
            assert int(tout[5][b]) == int(jout[5][b])
    if J == 1:
        assert jfail.any()


def test_extract_without_eob():
    """No masked end-of-block: argmax gives 0 and counts is 1."""
    word = torch.zeros((2, 1024), dtype=torch.int32) + 9       # literals
    mask = torch.zeros((2, 1024), dtype=torch.bool)
    mask[0, ::9] = True
    joined = torch.ones((2, 4), dtype=torch.bool)
    start = torch.zeros(2, dtype=torch.int32)
    jout = j_i2._extract(jnp.asarray(u32(word)), jnp.asarray(mask.numpy()),
                         jnp.asarray(joined.numpy()),
                         jnp.asarray(start.numpy()), 128, 256)
    tout = i2._extract(word, mask, joined, start, 128, 256)
    for k in (1, 2, 3, 4):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    assert tout[1].tolist() == [1, 1] and not tout[3].any()


def _symbols(seed, B=3, ns=64, max_dist=1 << 15):
    """Random live symbol fields (live, is_m, offs, dist) as numpy."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(2, ns, B)
    live = np.zeros((B, ns), bool)
    is_m = np.zeros((B, ns), bool)
    offs = np.zeros((B, ns), np.int32)
    dist = np.ones((B, ns), np.int32)
    for b in range(B):
        off = 0
        for k in range(int(counts[b]) - 1):
            m = bool(rng.integers(0, 2))
            live[b, k], is_m[b, k], offs[b, k] = True, m, off
            dist[b, k] = int(rng.integers(1, max_dist))
            off += int(rng.integers(3, 20)) if m else 1
    return live, is_m, offs, dist


@pytest.mark.parametrize("S_", [1 << 10, (1 << 17) + 1024])
def test_propagate_match_fields_equal(S_):
    """Both branches: the packed scatter-max (S <= 128K) and the owner
    slots (larger S)."""
    live, is_m, offs, dist = _symbols(7)
    jo = j_i2.propagate_match_fields(jnp.asarray(live), jnp.asarray(is_m),
                                     jnp.asarray(offs), jnp.asarray(dist), S_)
    to = i2.propagate_match_fields(tt(live), tt(is_m), tt(offs), tt(dist), S_)
    ism = np.asarray(jo[0])
    np.testing.assert_array_equal(to[0].numpy(), ism)
    if S_ <= 1 << 17:
        np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1]))
    else:        # o_dist is defined only where the owner is a match
        np.testing.assert_array_equal(to[1].numpy()[ism > 0],
                                      np.asarray(jo[1])[ism > 0])


def _compacted(stream):
    """(words, counts) of a stream's shards by the port's serial walk, and
    its numpy args."""
    ja, ta, word = _word(stream)
    words, counts = i2._walk(word, ta[2], 8 * ta[1], NS)
    return ja, ta, words, counts


@pytest.mark.parametrize("fault", [None, "out_lens", "window", "bad_code"])
@pytest.mark.parametrize("stream", ["jax_l1", "jax_l6"])
def test_resolve_equal(stream, fault):
    ja, ta, words, counts = _compacted(stream)
    words = words.clone()
    out_lens = ja[9].copy()
    ctx0 = np.frombuffer(text(CTX * 40)[-32768:], np.uint8).copy()
    if fault == "out_lens":
        out_lens[1] -= 5
    elif fault == "window":
        # the first match of row 0 reaches before the context
        k = int(np.nonzero(((u32(words[0]) >> 6) & 3) == 1)[0][0])
        words[0, k] = int(words[0, k]) | (0x7FFF << 16)
    elif fault == "bad_code":
        words[2, 5] = int(words[2, 5]) | (3 << 6)
    jout, jerr = j_i2._resolve(jnp.asarray(u32(words)),
                               jnp.asarray(counts.numpy()),
                               jnp.asarray(out_lens), jnp.asarray(ctx0), S)
    tout, terr = i2._resolve(words, counts, tt(out_lens), tt(ctx0), S)
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    # a distance that reaches before the member's start lands in the
    # 32 KiB context (dist <= CTX), so it reads zeros and flags nothing
    assert bool(np.asarray(jerr).any()) == (fault in ("out_lens", "bad_code"))


# ---------------------------------------------------------------------------
# the batched decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", list(STREAMS))
def test_decode_batch2_equal(stream):
    ja, ta = _args(stream)
    jout = j_i2.decode_batch2(*_j(ja), S=S, NS=NS, interpret=True)
    tout = i2.decode_batch2(*ta, S=S, NS=NS)
    assert len(jout) == len(tout) == 4
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not np.asarray(jout[1]).any() and not np.asarray(jout[3]).any()
    data = inputs("text")
    for b in range(len(ja[9])):
        got = tout[0].numpy()[b * S:b * S + ja[9][b]].tobytes()
        assert got == data[b * S:b * S + ja[9][b]]


@pytest.mark.parametrize("stream", list(STREAMS))
def test_decode_batch_equal(stream):
    ja, ta = _args(stream)
    jout = j_i2.decode_batch(*_j(ja), S=S, NS=NS, interpret=True)
    tout = i2.decode_batch(*ta, S=S, NS=NS)
    assert len(jout) == len(tout) == 3
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pack_flags_and_bucket():
    err = torch.tensor([0, 2, 0])
    spec = torch.tensor([True, False, False])
    np.testing.assert_array_equal(
        i2._pack_flags(err, spec).numpy(),
        np.asarray(j_i2._pack_flags(jnp.asarray(err.numpy()),
                                    jnp.asarray(spec.numpy()))))
    for c in (1, 8192, 8193, 70000):
        assert i2._bucket(c) == j_i2._bucket(c)


# ---------------------------------------------------------------------------
# the slice as a whole, on the CPU
# ---------------------------------------------------------------------------

# (stream name, maker): JAX-made at levels 1 and 6, port-made at 1 and 3
MEMBERS = [("jax", "text", 1), ("jax", "text", 6), ("port", "text", 1),
           ("port", "text", 3), ("port", "random", 3), ("port", "period", 1),
           ("port", "period", 3), ("port", "segmented", 1),
           ("port", "segmented", 3),
           ("port", "empty", 1), ("port", "one", 3)]


def _blob(maker, name, level):
    return (jax_blob if maker == "jax" else port_blob)(name, level)


@pytest.mark.parametrize("walk", ["lanes", "serial"])
@pytest.mark.parametrize("maker,name,level", MEMBERS)
def test_decompress_device_equal(maker, name, level, walk):
    blob = _blob(maker, name, level)
    data = inputs(name)
    i2.STATS.clear()
    out = i2.decompress_device(blob, batch=BATCH, device="cpu", walk=walk)
    assert out == data
    if name == "segmented":
        assert i2.STATS["segmented_reroutes"] == 1
        assert i2.STATS["chained_members"] == 1
    elif name == "text":
        key = "decode_batch2" if walk == "lanes" else "decode_batch"
        assert i2.STATS[key] >= 1
    assert out == j_i2.decompress_device(blob, batch=BATCH, interpret=True)
    assert ftt.gzip.decompress(blob, device="cpu", batch=BATCH,
                               walk=walk) == data


def test_walk_from_environment(monkeypatch):
    blob = port_blob("text", 1)
    monkeypatch.setenv("FLATE_TPU_INFLATE_WALK", "serial")
    i2.STATS.clear()
    assert i2.decompress_device(blob, batch=BATCH, device="cpu") \
        == inputs("text")
    assert i2.STATS["decode_batch"] >= 1 and i2.STATS["decode_batch2"] == 0
    monkeypatch.setenv("FLATE_TPU_INFLATE_WALK", "sideways")
    with pytest.raises(ValueError):
        i2.decompress_device(blob, device="cpu")


def test_two_members():
    blob = port_blob("text", 3) + port_blob("period", 1)
    data = inputs("text") + inputs("period")
    assert i2.decompress_device(blob, batch=BATCH, device="cpu") == data
    assert j_i2.decompress_device(blob, batch=BATCH, interpret=True) == data
    assert ftt.gzip.decompress(blob, device="cpu") == data


def test_unproven_speculation_retries_serially(monkeypatch):
    """With one join step most lanes stay unproven: each batch is walked
    again with the exact serial walk, on the same device, and counted."""
    real = i2._lane_walk
    monkeypatch.setattr(i2, "_lane_walk",
                        lambda w, s, n, G=i2.LANE_G: real(w, s, n, G=G, J=1))
    i2.STATS.clear()
    blob = port_blob("text", 3)
    assert i2.decompress_device(blob, batch=BATCH, device="cpu") \
        == inputs("text")
    assert i2.STATS["decode_batch2"] == 2
    assert i2.STATS["decode_batch"] == i2.STATS["serial_retries"] >= 1


def test_corrupt_footer_raises_checksum():
    blob = bytearray(port_blob("text", 1))
    blob[-5] ^= 0xFF
    with pytest.raises(errors.WrongGzipChecksum):
        i2.decompress_device(bytes(blob), batch=BATCH, device="cpu")
    blob = bytearray(port_blob("text", 1))
    blob[-1] ^= 0x01
    with pytest.raises(errors.WrongGzipSize):
        ftt.gzip.decompress(bytes(blob), device="cpu")


@pytest.mark.parametrize("name", ["text", "segmented"])
def test_flipped_body_bit_raises(name):
    blob = bytearray(port_blob(name, 3))
    blob[len(blob) // 2] ^= 0x40
    with pytest.raises(errors.FlateError):
        i2.decompress_device(bytes(blob), batch=BATCH, device="cpu")


@pytest.mark.parametrize("level", [1, 6, 9])
def test_unindexed_stream(level):
    data = text(20000)
    blob = gz(data, level)
    with pytest.raises(LookupError):
        i2.decompress_device(blob, device="cpu")
    assert ftt.gzip.decompress(blob, device="cpu") == data
    assert ftt.zlib.decompress(zlib.compress(data, level),
                               device="cpu") == data
    raw = zlib.compress(data, level)[2:-4]
    assert ftt.flate.decompress(raw, device="cpu") == data


def test_oversized_index_raises_lookup():
    """Shards over 128 KiB exceed the packed-field bound of _resolve."""
    from flate_tpu_torch import containers, shard_index
    extra = shard_index.build_index_extra([10], [(1 << 17) + 1])
    hdr = containers.write_header(containers.Container.GZIP,
                                  containers.GzipMetadata(extra=extra))
    with pytest.raises(LookupError):
        i2.decompress_device(hdr + b"\x00" * 18, device="cpu")


def test_decompress_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is untestable")
    blob = port_blob("one", 3)
    with pytest.raises(errors.DeviceUnavailable):
        ftt.gzip.decompress(blob)
    with pytest.raises(errors.DeviceUnavailable):
        i2.decompress_device(blob)
    assert struct.unpack("<I", blob[-4:])[0] == 1
