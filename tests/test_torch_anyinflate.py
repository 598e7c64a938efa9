"""Port device/anyinflate.py against flate_tpu/jx/anyinflate.py on the CPU.

Unindexed streams come from CPython's zlib at levels 0, 1, 6 and 9; the
stage tests push the JAX package's pack_coded_run numbers (of the port's
own level-1 and level-3 streams) through both sides.  The JAX side runs its Pallas kernels in interpret mode.
Tolerance: exact (integers and bytes), words compared as uint32 below
`counts`.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu import errors as j_errors
from flate_tpu.containers import Container as JContainer
from flate_tpu.jx import anyinflate as j_ai

import flate_tpu as ft
import flate_tpu_torch as ftt
from flate_tpu_torch import errors
from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import anyinflate as ai
from flate_tpu_torch.device import inflate2 as i2

from _torch_corpora import corpus, trap_stream, tt, u32
from _torch_decode_ref import S, coded_run, gz, port_blob, text

NS = 2 * 8192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain walks are thousands of tiny tensor ops: one intra-op thread
    runs them faster, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_any(blob: bytes) -> bytes:
    return j_ai.decompress_device_any(blob, chunk_bytes=32768, interpret=True)


@pytest.mark.parametrize("name", ["CHUNK_BYTES", "SPAN0", "MAX_SPAN", "RES_B",
                                  "MAX_S", "CTX"])
def test_constants_equal(name):
    assert getattr(ai, name) == getattr(j_ai, name)
    for n, lo in ((1, 1), (5, 1), (9000, 8192), (1024, 1024)):
        assert ai._bucket(n, lo) == j_ai._bucket(n, lo)


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level,strategy", [
    (0, zlib.Z_DEFAULT_STRATEGY), (6, zlib.Z_FIXED),
    (1, zlib.Z_DEFAULT_STRATEGY), (9, zlib.Z_DEFAULT_STRATEGY)])
def test_plan_block_at_equal(level, strategy):
    body = gz(text(90000), level, strategy)[10:-8]
    p = ai.plan_block_at(body, 0)
    q = j_ai.plan_block_at(body, 0)
    assert (p.kind, p.pos, p.bfinal) == (q.kind, q.pos, q.bfinal)
    if p.kind == "stored":
        assert (p.stored_off, p.stored_len, p.end_bit) == \
            (q.stored_off, q.stored_len, q.end_bit)
        # the next header sits at end_bit: plan it as well
        p2, q2 = ai.plan_block_at(body, p.end_bit), \
            j_ai.plan_block_at(body, q.end_bit)
        assert (p2.kind, p2.stored_len) == (q2.kind, q2.stored_len)
    else:
        assert p.body_bit == q.body_bit
        for a, b in zip(p.ll + p.d, q.ll + q.d):
            np.testing.assert_array_equal(a, b)


def test_plan_block_at_errors():
    with pytest.raises(errors.InvalidBlockType):
        ai.plan_block_at(b"\x07\x00\x00\x00", 0)
    with pytest.raises(errors.WrongStoredBlockNlen):
        ai.plan_block_at(b"\x01\x05\x00\x00\x00abcde", 0)
    with pytest.raises(errors.EndOfStream):
        ai.plan_block_at(b"\x01\x05\x00\xfa\xffab", 0)


# ---------------------------------------------------------------------------
# device stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serial", [False, True])
@pytest.mark.parametrize("level", [1, 3])
def test_symbol_batch_equal(level, serial):
    ja = coded_run(port_blob("text", level))[:9]
    ta = i2.args_from_numpy(ja, "cpu")
    jout = j_ai.symbol_batch(*[jnp.asarray(x) for x in ja], NS=NS,
                             serial=serial, interpret=True)
    tout = ai.symbol_batch(*ta, NS=NS, serial=serial)
    assert len(jout) == len(tout) == 6
    jc = np.asarray(jout[1])
    for k in range(1, 6):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    jw = np.asarray(jout[0])
    for b in range(len(jc)):
        np.testing.assert_array_equal(u32(tout[0][b, :jc[b]]), jw[b, :jc[b]])
    assert np.asarray(jout[3]).all() and not np.asarray(jout[2]).any()


def test_symbol_batch_short_span():
    """A span that ends before its EOB: has_eob false on both sides.  An
    EOB that ends past the span (the JAX lane walk finds the last row's
    in the lane that holds the span's end; its serial walk stops at the
    span's end) is none for the port.  A row without one reports its cut
    instead of JAX's unproven flag: proven, the same counts, output bytes
    and end bit by the lane and the serial walk, the end bit inside the
    span, and its words the JAX serial walk's first counts words."""
    ja = list(coded_run(port_blob("text", 3))[:9])
    ja[1] = ja[1] // 2
    nbits = 8 * np.asarray(ja[1])
    ta = i2.args_from_numpy(ja, "cpu")
    cuts = []
    for serial in (False, True):
        jout = j_ai.symbol_batch(*[jnp.asarray(x) for x in ja], NS=NS,
                                 serial=serial, interpret=True)
        tout = ai.symbol_batch(*ta, NS=NS, serial=serial)
        jeob = np.asarray(jout[3]) & (np.asarray(jout[5]) <= nbits)
        np.testing.assert_array_equal(tout[3].numpy(), jeob)
        assert not np.asarray(jout[3])[:3].any()
        assert not jeob.any() and not tout[2].numpy().any()
        counts, end_bit = tout[1].numpy(), tout[5].numpy()
        assert (counts > 0).all() and (end_bit <= nbits).all()
        assert (end_bit > nbits - 48).all()
        if serial:
            jw = np.asarray(jout[0])
            for b in range(len(counts)):
                np.testing.assert_array_equal(u32(tout[0][b, :counts[b]]),
                                              jw[b, :counts[b]])
        cuts.append([tout[k].numpy() for k in (1, 4, 5)])
    for a, b in zip(*cuts):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", [None, "out_lens", "window", "bad_code"])
@pytest.mark.parametrize("S_", [8192, (1 << 17) + 1024])
def test_resolve_compact_equal(S_, fault):
    """Both propagate branches (S within and beyond the 32-bit pack)."""
    ja = coded_run(port_blob("text", 3))
    ta = i2.args_from_numpy(ja, "cpu")
    words, counts, _, _, out_len, _ = ai.symbol_batch(*ta[:9], NS=NS)
    words = words.clone()
    out_lens = out_len.numpy().copy()
    np.testing.assert_array_equal(out_lens, ja[9])
    ctx0 = np.frombuffer(text(40000)[-32768:], np.uint8).copy()
    if fault == "out_lens":
        out_lens[1] -= 5
    elif fault == "window":
        k = int(np.nonzero(((u32(words[0]) >> 6) & 3) == 1)[0][0])
        words[0, k] = int(words[0, k]) | (0x7FFF << 16)
    elif fault == "bad_code":
        words[2, 5] = int(words[2, 5]) | (3 << 6)
    jout, jerr = j_ai.resolve_compact(
        jnp.asarray(u32(words)), jnp.asarray(counts.numpy()),
        jnp.asarray(out_lens), jnp.asarray(ctx0), S=S_, interpret=True)
    tout, terr = ai.resolve_compact(words, counts, tt(out_lens), tt(ctx0),
                                    S=S_)
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    total = int(out_lens.sum())
    np.testing.assert_array_equal(tout.numpy()[:total],
                                  np.asarray(jout)[:total])
    assert bool(np.asarray(jerr).any()) == (fault in ("out_lens", "bad_code"))
    if fault is None:
        assert tout.numpy()[:total].tobytes() == text(3 * S + 500)


def test_pack_meta_equal():
    vals = [torch.tensor([3, 4]), torch.tensor([False, True]),
            torch.tensor([True, True]), torch.tensor([100, 7]),
            torch.tensor([999, 12])]
    np.testing.assert_array_equal(
        ai._pack_meta(*vals).numpy(),
        np.asarray(j_ai._pack_meta(*[jnp.asarray(v.numpy()) for v in vals])))


# ---------------------------------------------------------------------------
# the slice as a whole, on the CPU
# ---------------------------------------------------------------------------

def _incompressible():
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()


def _mixed():
    rng = np.random.default_rng(7)
    return (text(20000)
            + rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()) * 2


CASES = {
    "text_l1": lambda: gz(text(80000), 1),
    "text_l6": lambda: gz(text(80000), 6),
    "text_l9": lambda: gz(text(80000), 9),
    "stored": lambda: gz(text(70000), 0),
    "incompressible": lambda: gz(_incompressible(), 6),
    "tiny_fixed": lambda: gz(b"hello hello hello", 6),
    "mixed": lambda: gz(_mixed(), 6),
    "long_runs": lambda: gz(b"a" * 70000 + text(10000), 6),
    "two_members": lambda: gz(text(20000), 6) + gz(b"x" * 10000, 6),
    "empty": lambda: gz(b"", 6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decompress_any_equal(case):
    blob = CASES[case]()
    want = zlib.decompress(blob, 31) if case != "two_members" else \
        text(20000) + b"x" * 10000
    i2.STATS.clear()
    out = ai.decompress_device_any(blob, device="cpu")
    assert out == want
    assert i2.STATS["chained_members"] == (2 if case == "two_members" else 1)
    assert out == _jax_any(blob)
    assert ftt.gzip.decompress(blob, device="cpu") == want


@pytest.mark.parametrize("level", [1, 6, 9])
def test_zlib_and_raw_containers(level):
    data = text(60000)
    z = zlib.compress(data, level)
    assert ai.decompress_device_any(z, Container.ZLIB, device="cpu") == data
    assert ai.decompress_device_any(z[2:-4], Container.RAW,
                                    device="cpu") == data
    assert ftt.zlib.decompress(z, device="cpu") == data
    bad = bytearray(z)
    bad[-1] ^= 1
    with pytest.raises(errors.WrongZlibChecksum):
        ftt.zlib.decompress(bytes(bad), device="cpu")
    with pytest.raises(errors.BadZlibHeader):
        ftt.zlib.decompress(b"\x79" + z[1:], device="cpu")


def test_span_escalation():
    """A block whose compressed span passes the first 64 KiB."""
    rng = np.random.default_rng(2)
    # near-incompressible symbols of a 64-letter alphabet: one long
    # dynamic block, ~6 bits a byte
    data = rng.integers(0, 64, 100000, dtype=np.uint8).tobytes()
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    raw = c.compress(data) + c.flush()
    assert len(raw) > ai.SPAN0
    assert ai.decompress_device_any(raw, Container.RAW, device="cpu") == data


def test_corruption_raises():
    data = text(100000)
    blob = bytearray(gz(data, 6))
    blob[len(blob) // 2] ^= 0x10
    with pytest.raises(errors.FlateError):
        ai.decompress_device_any(bytes(blob), device="cpu")
    blob = bytearray(gz(data, 6))
    blob[-6] ^= 0xFF
    with pytest.raises(errors.WrongGzipChecksum):
        ai.decompress_device_any(bytes(blob), device="cpu")
    assert ai.decompress_device_any(bytes(blob), verify=False,
                                    device="cpu") == data
    with pytest.raises(errors.BadGzipHeader):
        ftt.gzip.decompress(b"\x1f\x8c" + bytes(blob[2:]), device="cpu")
    with pytest.raises(errors.EndOfStream):
        ftt.gzip.decompress(bytes(blob[:7]), device="cpu")


def _cut_streams():
    """name -> (namespace, stream, body start): a zlib level-6 member, a
    gzip member, and a zlib member with a full flush in its middle (a cut
    there leaves whole blocks and no final one)."""
    data = text(60000)
    c = zlib.compressobj(6)
    flushed = c.compress(data[:30000]) + c.flush(zlib.Z_FULL_FLUSH)
    return {"zlib": ("zlib", zlib.compress(data, 6), 2),
            "gzip": ("gzip", gz(data, 6), 10),
            "flushed": ("zlib", flushed + c.compress(data[30000:])
                        + c.flush(), 2), "flush_at": len(flushed)}


CUTS = _cut_streams()


@pytest.mark.parametrize("where", ["body_1_7", "body_1_2", "body_end",
                                   "footer"])
@pytest.mark.parametrize("name", ["zlib", "gzip"])
def test_truncated_stream_raises_as_jax(name, where):
    """A member cut in its body or its footer raises EndOfStream, the
    JAX public decode's class, on the chained route (ROADMAP C.8)."""
    ns, blob, _ = CUTS[name]
    foot = {"zlib": 4, "gzip": 8}[name]
    n = len(blob)
    cut = {"body_1_7": n // 7, "body_1_2": n // 2,
           "body_end": n - foot - 2, "footer": n - foot // 2}[where]
    with pytest.raises(j_errors.FlateError) as jexc:
        getattr(ft, ns).decompress(blob[:cut], device=True)
    with pytest.raises(errors.FlateError) as texc:
        getattr(ftt, ns).decompress(blob[:cut], device="cpu")
    assert type(jexc.value).__name__ == "EndOfStream"
    assert type(texc.value).__name__ == "EndOfStream"


def test_stream_cut_between_blocks_raises_end_of_stream():
    """Cut right after a full flush: every block decodes, and the chain
    reaches the end of the body before a final block."""
    ns, blob, _ = CUTS["flushed"]
    cut = CUTS["flush_at"] + 2
    with pytest.raises(j_errors.EndOfStream):
        ft.zlib.decompress(blob[:cut], device=True)
    with pytest.raises(errors.EndOfStream):
        ftt.zlib.decompress(blob[:cut], device="cpu")
    assert ftt.zlib.decompress(blob, device="cpu") == text(60000)


@pytest.mark.parametrize("where,fill", [("middle", 0xFF), ("head", 0xFF),
                                        ("head", 0x00)])
def test_corrupt_stream_raises_as_jax(where, fill):
    """Eight bytes overwritten in a Huffman-only member: the chained route
    raises the JAX public decode's class (a garbage block type, an
    over-subscribed code), not EndOfStream."""
    rng = np.random.default_rng(12)
    data = rng.integers(0, 64, 50000, dtype=np.uint8).tobytes()
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    raw = bytearray(c.compress(data) + c.flush())
    at = len(raw) // 2 if where == "middle" else 100
    raw[at:at + 8] = bytes([fill]) * 8
    with pytest.raises(j_errors.FlateError) as jexc:
        ft.flate.decompress(bytes(raw), device=True)
    with pytest.raises(errors.FlateError) as texc:
        ftt.flate.decompress(bytes(raw), device="cpu")
    assert type(texc.value).__name__ == type(jexc.value).__name__
    assert type(texc.value).__name__ != "EndOfStream"


def _tail_member(ns: str, kind: str) -> bytes:
    rng = np.random.default_rng(12)
    data = rng.integers(0, 64, 50000, dtype=np.uint8).tobytes()
    wbits = {"zlib": 15, "gzip": 31}[ns]
    if kind == "huff":
        c = zlib.compressobj(6, zlib.DEFLATED, wbits, 9, zlib.Z_HUFFMAN_ONLY)
    else:
        c = zlib.compressobj(6, zlib.DEFLATED, wbits)
        data = bytes(range(256)) * 300 + data
    return c.compress(data) + c.flush()


@pytest.mark.parametrize("ns,kind,k,fill", [
    ("zlib", "huff", 6, 0x00), ("zlib", "huff", 3, 0xFF),
    ("gzip", "huff", 6, 0xA7), ("gzip", "huff", 8, 0xFF),
    ("zlib", "l6", 6, 0xFF), ("gzip", "l6", 3, 0x55)])
def test_corrupt_body_tail_raises_as_jax(ns, kind, k, fill):
    """The last k bytes of a complete member's body overwritten, inside the
    48 bits the end-of-body test allows a bad code: the port raises the
    JAX public decode's class (EndOfStream where the walk runs off the
    body, the checksum's where the body still decodes)."""
    blob = bytearray(_tail_member(ns, kind))
    end = len(blob) - {"zlib": 4, "gzip": 8}[ns]
    blob[end - k:end] = bytes([fill]) * k
    with pytest.raises(j_errors.FlateError) as jexc:
        getattr(ft, ns).decompress(bytes(blob), device=True)
    with pytest.raises(errors.FlateError) as texc:
        getattr(ftt, ns).decompress(bytes(blob), device="cpu")
    assert type(texc.value).__name__ == type(jexc.value).__name__


def test_any_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is untestable")
    with pytest.raises(errors.DeviceUnavailable):
        ai.decompress_device_any(gz(b"abc", 6))


# ---------------------------------------------------------------------------
# chunk entries from the scanner: many chains a member
# ---------------------------------------------------------------------------

CHUNK = 32768


def _text_l(level: int) -> bytes:
    return zlib.compress(text(400_000), level)


def _mixed_blocks() -> bytes:
    """Stored and coded blocks mixed: text and random runs at level 6."""
    rng = np.random.default_rng(21)
    parts = [text(30000), rng.integers(0, 256, 30000, dtype=np.uint8)
             .tobytes()] * 4
    return gz(b"".join(parts), 6)


CHUNKED = {
    "text_l1": (lambda: _text_l(1), Container.ZLIB),
    "text_l6": (lambda: _text_l(6), Container.ZLIB),
    "text_l9": (lambda: _text_l(9), Container.ZLIB),
    "two_members": (lambda: gz(text(150_000), 6)
                    + gz(corpus("mixed", 120_000, seed=3), 1),
                    Container.GZIP),
    "stored_and_coded": (_mixed_blocks, Container.GZIP),
}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_decompress_any_chunked_equal(case):
    """Scanned chunk entries at 32 KiB: the JAX package's bytes, with more
    than one chain head a member that spans chunks."""
    make, container = CHUNKED[case]
    blob = make()
    i2.STATS.clear()
    out = ai.decompress_device_any(blob, container, chunk_bytes=CHUNK,
                                   device="cpu")
    heads, members = i2.STATS["chain_heads"], i2.STATS["chained_members"]
    assert out == j_ai.decompress_device_any(
        blob, JContainer(container.value), chunk_bytes=CHUNK,
        interpret=True)
    assert heads > members
    if container is Container.ZLIB:
        assert out == zlib.decompress(blob)
        i2.STATS.clear()
        one = ai._decompress_member_any(blob, 0, container, True,
                                        torch.device("cpu"), entries=[0])
        assert one == (out, len(blob)) and i2.STATS["chain_heads"] == 1


def test_corrupted_chunked_raises_as_jax():
    blob = bytearray(_text_l(6))
    blob[len(blob) // 2] ^= 0x10
    with pytest.raises(j_errors.FlateError) as jexc:
        j_ai.decompress_device_any(bytes(blob), JContainer.ZLIB,
                                   chunk_bytes=CHUNK, interpret=True)
    with pytest.raises(errors.FlateError) as texc:
        ai.decompress_device_any(bytes(blob), Container.ZLIB,
                                 chunk_bytes=CHUNK, device="cpu")
    assert type(texc.value).__name__ == type(jexc.value).__name__


def test_false_entry_chain_does_not_fail_the_member():
    """A dynamic header inside a stored block's payload is a valid scanner
    entry whose chain runs into garbage (here a block type 3).  zlib
    decodes the stream; the JAX package raises at that chain's failure
    (ROADMAP C); the port raises a chain's error only once the chain from
    bit 0 reaches it."""
    blob = trap_stream()
    want = zlib.decompress(blob)
    i2.STATS.clear()
    assert ai.decompress_device_any(blob, Container.ZLIB, chunk_bytes=CHUNK,
                                    device="cpu") == want
    assert i2.STATS["chain_heads"] == 2
    with pytest.raises(j_errors.InvalidBlockType):
        j_ai.decompress_device_any(blob, JContainer.ZLIB, chunk_bytes=CHUNK,
                                   interpret=True)


def test_plan_block_at_fails_only_with_flate_errors():
    """Every bit offset of a stream is a possible false entry: the host bit
    cursor either plans a block there or raises a FlateError."""
    body = _text_l(6)[2:3000] + np.random.default_rng(4).integers(
        0, 256, 1000, dtype=np.uint8).tobytes()
    planned = 0
    for pos in range(0, 8 * len(body), 3):
        try:
            ai.plan_block_at(body, pos)
            planned += 1
        except errors.FlateError:
            pass
    assert planned > 0
