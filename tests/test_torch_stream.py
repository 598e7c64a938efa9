"""The port's streaming device encoder against the JAX package's, byte for
byte: pipeline2.DeviceEncoder, the streaming compressor of every container
(write / flush / finish / reset / set_writer, gzip metadata, a preset
dictionary), compress(reader | data, writer=, meta=, dictionary=), the
zlib FDICT header and the gzip CLI.  Small shapes (shards of 2048 bytes,
512 bytes of context, batches of 3), levels 1 and 6, and the compressor and
the dictionary split of the DeviceEncoder at every other level; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_api_device.py
does.  At levels 7-9 its traces take minutes: there the port is held to the
sha256 of the JAX bytes (STREAM_PINS, ENCODER_PINS), which the slow cases
recompute."""

import gzip as pygz
import hashlib
import io
import zlib

import pytest
import torch

import flate_tpu as ft
from flate_tpu import block as j_block
from flate_tpu import containers as j_containers
from flate_tpu.bitpack import BitSink
from flate_tpu.deflate import CompressOptions
from flate_tpu.jx import pipeline2 as j_pipeline2

import flate_tpu_torch as ftt
from flate_tpu_torch import api, containers
from flate_tpu_torch.device import pipeline2

from _torch_corpora import corpus

S, CTX, BATCH = 2048, 512, 3
LEVELS = (1, 6)
JAX_LEVELS = (2, 3, 4, 5)    # the other levels whose JAX traces fit tier 1
PIN_LEVELS = (7, 8, 9)       # ... and those held to STREAM_PINS, ENCODER_PINS
MORE_LEVELS = [*JAX_LEVELS,
               *(pytest.param(L, marks=pytest.mark.slow) for L in PIN_LEVELS)]
WBITS = {"gzip": 31, "zlib": 15, "flate": -15}
J_NS = {"gzip": ft.gzip, "zlib": ft.zlib, "flate": ft.flate}

torch.set_num_threads(1)         # the squeeze DP is thousands of tiny ops


def _opts(level):
    return CompressOptions(level=level, shard_len=S, ctx=CTX, batch=BATCH,
                           interpret=True)


PORT_KW = dict(shard_len=S, ctx=CTX, batch=BATCH, device="cpu")
DATA = corpus("mixed", 7 * S + 333, seed=1)       # three batches: 3, 3, 2
DICT = corpus("text", 700, seed=2)


def _digest(parts) -> str:
    """sha256 of a list of byte strings, each behind its length."""
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(8, "little") + p)
    return h.hexdigest()


# _digest of the JAX package's outputs at PIN_LEVELS: the streaming
# compressor's SCRIPT snapshots by namespace, and the "dictionary" split of
# the DeviceEncoder (its pieces, then repr((comp_lens, out_lens)))
STREAM_PINS = {
    ("gzip", 7):
        "26ea5f8b6247b777442d180c422db868b68f2631fd948383c648781f19fca8b3",
    ("zlib", 7):
        "a03a14300f063bbc1fd443fcaf528245f9cf01541bafe599ea1d0d9774183a5b",
    ("flate", 7):
        "a4d3d7efd7e309a85c7e7841300272adf0470ae14b417a4c7f2f4696cc2ef20b",
    ("gzip", 8):
        "5a18aafbf1f71cf5bcfd386fe920f43b088804858876f817d212d2b81f1ba778",
    ("zlib", 8):
        "d04fac850f4f0354c70e4aeb0ef916c8fa1d282db451db0e8a471b590428dfac",
    ("flate", 8):
        "3f8d6fcd72499231e6027f4cff28b25ac0893e689520ad3d75c6f6d3df5bba7b",
    ("gzip", 9):
        "2781c6ac492532543276b8b6dbae1898b8f43fa50de8c422f1f70f7b5e6d27c1",
    ("zlib", 9):
        "1048c6ec208422879947854622f5bb7f496169b1cb4e1cf14a4d04bd41bf4bc1",
    ("flate", 9):
        "8802761a695c1dbb4831785af4fdefba6f7e04c7b12d0531d8d82c36b346f2a8",
}
ENCODER_PINS = {
    7: "3d27536d2496908b9211bf0b4dfcc4f29e460b01c0510fb4171063819e990757",
    8: "e3cc2de20ee7ea32496e4f8814b349b3011656d3a650b9c064a0e52cc339015b",
    9: "d8442d46df6d73bfa2e7aab102709158c17ca4ae0b0a4e612a0d76571a9b7885",
}


def _j_meta(**kw):
    return j_containers.GzipMetadata(**kw)


def _meta(**kw):
    return containers.GzipMetadata(**kw)


# ---- DeviceEncoder --------------------------------------------------------

SPLITS = {
    "one_shot": ([None], None),
    "aligned": ([3 * S, None], None),
    "unaligned": ([3 * S + 17, None], None),
    "empty_final": ([len(DATA), 0], None),
    "dictionary": ([3 * S + 17, None], DICT),
}


def _encode_calls(enc, cuts):
    """Call enc.encode on consecutive pieces of DATA: each cut is a piece's
    length (None: the rest), the last call final."""
    outs, at = [], 0
    for i, cut in enumerate(cuts):
        end = len(DATA) if cut is None else at + cut
        outs.append(enc.encode(DATA[at:end], final=i == len(cuts) - 1))
        at = end
    return outs


@pytest.mark.parametrize("case", list(SPLITS))
@pytest.mark.parametrize("level", LEVELS)
def test_device_encoder_equal(level, case):
    cuts, d = SPLITS[case]
    kw = dict(level=level, shard_len=S, ctx=CTX, batch=BATCH, dictionary=d)
    ref = j_pipeline2.DeviceEncoder(interpret=True, **kw)
    enc = pipeline2.DeviceEncoder(device="cpu", **kw)
    want, got = _encode_calls(ref, cuts), _encode_calls(enc, cuts)
    assert got == want
    assert enc.comp_lens == ref.comp_lens
    assert enc.out_lens == ref.out_lens
    assert sum(enc.out_lens) == len(DATA)
    dec = zlib.decompressobj(-15, zdict=d) if d else zlib.decompressobj(-15)
    assert dec.decompress(b"".join(got)) == DATA


def _dictionary_split(level, device):
    """The "dictionary" split through the port's DeviceEncoder (a device)
    or the JAX package's (None): its pieces and their _digest, the
    lengths after them."""
    cuts, d = SPLITS["dictionary"]
    kw = dict(level=level, shard_len=S, ctx=CTX, batch=BATCH, dictionary=d)
    enc = (j_pipeline2.DeviceEncoder(interpret=True, **kw) if device is None
           else pipeline2.DeviceEncoder(device=device, **kw))
    outs = _encode_calls(enc, cuts)
    lens = ([int(x) for x in enc.comp_lens], [int(x) for x in enc.out_lens])
    dec = zlib.decompressobj(-15, zdict=d)
    assert dec.decompress(b"".join(outs)) == DATA
    assert sum(lens[1]) == len(DATA)
    return outs, _digest(outs + [repr(lens).encode()])


@pytest.mark.parametrize("level", MORE_LEVELS)
def test_device_encoder_dictionary_levels(level):
    """The dictionary split at every other level; at PIN_LEVELS the JAX
    outputs also equal their pin."""
    want, pin = _dictionary_split(level, None)
    got, digest = _dictionary_split(level, "cpu")
    assert got == want and digest == pin
    if level in ENCODER_PINS:
        assert pin == ENCODER_PINS[level]


@pytest.mark.parametrize("level", PIN_LEVELS)
def test_device_encoder_dictionary_pin(level):
    assert _dictionary_split(level, "cpu")[1] == ENCODER_PINS[level]


def test_device_encoder_closed_after_final():
    enc = pipeline2.DeviceEncoder(level=1, device="cpu", shard_len=S,
                                  ctx=CTX, batch=BATCH)
    enc.encode(b"abc", final=True)
    with pytest.raises(ValueError):
        enc.encode(b"more")
    with pytest.raises(ValueError):
        pipeline2.DeviceEncoder(level=10, device="cpu")


# ---- the streaming compressor -------------------------------------------

def _drive(c, out, script):
    """Run a script of ("w", n) writes of the next n bytes of DATA,
    ("f",) flushes, ("r",) resets and ("x",) finishes against compressor
    c; returns what `out` held after each step."""
    at, seen = 0, []
    for step in script:
        if step[0] == "w":
            c.write(DATA[at:at + step[1]])
            at += step[1]
        elif step[0] == "f":
            c.flush()
        elif step[0] == "r":
            c.reset()
        else:
            c.finish()
        seen.append(out.getvalue())
    return seen


# uneven writes, a flush with data buffered, a bare flush, a finish, a
# reset to a second member and its finish
SCRIPT = [("w", 1000), ("w", 3 * S + 17), ("f",), ("f",), ("w", 2 * S + 5),
          ("w", 1500), ("x",), ("r",), ("w", 4 * S), ("x",)]


def _port_stream(ns, level, meta=None, **kw):
    po = io.BytesIO()
    pc = getattr(ftt, ns).compressor(po, level, meta=meta, **kw, **PORT_KW)
    return _drive(pc, po, SCRIPT)


def _streams(ns, level, **kw):
    jo = io.BytesIO()
    jmeta = kw.pop("j_meta", None)
    pmeta = kw.pop("meta", None)
    jc = J_NS[ns].compressor(jo, level=level, opts=_opts(level),
                             device=True, meta=jmeta, **kw)
    return _drive(jc, jo, SCRIPT), _port_stream(ns, level, pmeta, **kw)


def _check_stream(ns, got):
    """What SCRIPT's snapshots of a stream must hold."""
    # after the flush the writer holds a decodable prefix of the input
    after_flush = got[SCRIPT.index(("f",))]
    dec = zlib.decompressobj(WBITS[ns])
    assert dec.decompress(after_flush) == DATA[:1000 + 3 * S + 17]
    # the bare flush added the sync marker alone
    assert got[3] == got[2] + api.FLUSH_MARKER
    # two members: the first finished, then the second after reset()
    first = got[SCRIPT.index(("x",))]
    n1 = 1000 + 3 * S + 17 + 2 * S + 5 + 1500
    assert zlib.decompress(first, WBITS[ns]) == DATA[:n1]
    second = got[-1][len(first):]
    assert zlib.decompress(second, WBITS[ns]) == DATA[n1:n1 + 4 * S]


@pytest.mark.parametrize("ns", ["gzip", "zlib", "flate"])
@pytest.mark.parametrize("level", [*LEVELS, *MORE_LEVELS])
def test_compressor_equal(ns, level):
    """At PIN_LEVELS the JAX streams also equal their pin."""
    want, got = _streams(ns, level)
    assert got == want
    if (ns, level) in STREAM_PINS:
        assert _digest(want) == STREAM_PINS[ns, level]
    _check_stream(ns, got)


@pytest.mark.parametrize("ns", ["gzip", "zlib", "flate"])
@pytest.mark.parametrize("level", PIN_LEVELS)
def test_compressor_equal_pin(ns, level):
    got = _port_stream(ns, level)
    assert _digest(got) == STREAM_PINS[ns, level]
    _check_stream(ns, got)


def test_compressor_gzip_meta_equal():
    kw = dict(filename=b"stream.bin", comment=b"from the card", hcrc=True,
              mtime=1234567, text=True)
    want, got = _streams("gzip", 6, j_meta=_j_meta(**kw), meta=_meta(**kw))
    assert got == want
    n1 = 1000 + 3 * S + 17 + 2 * S + 5 + 1500
    first = got[SCRIPT.index(("x",))]
    assert pygz.decompress(first) == DATA[:n1]
    assert first[3] == 1 | 2 | 8 | 16    # FTEXT, FHCRC, FNAME, FCOMMENT
    assert pygz.decompress(got[-1]) == DATA[:n1] + DATA[n1:n1 + 4 * S]


@pytest.mark.parametrize("ns", ["zlib", "flate"])
def test_compressor_dictionary_equal(ns):
    want, got = _streams(ns, 6, dictionary=DICT)
    assert got == want
    first = got[SCRIPT.index(("x",))]
    dec = zlib.decompressobj(WBITS[ns], zdict=DICT)
    n1 = 1000 + 3 * S + 17 + 2 * S + 5 + 1500
    assert dec.decompress(first) == DATA[:n1]


def test_compressor_set_writer_and_close():
    """set_writer() moves the rest of the member to another sink; close()
    finishes; writing after finish raises."""
    a, b = io.BytesIO(), io.BytesIO()
    c = ftt.gzip.compressor(a, 1, **PORT_KW)
    c.write(DATA[:5000])
    c.flush()
    c.set_writer(b)
    c.write(DATA[5000:])
    c.close()
    assert zlib.decompress(a.getvalue() + b.getvalue(), 31) == DATA
    with pytest.raises(ValueError):
        c.write(b"x")
    with pytest.raises(ValueError):
        c.flush()
    with pytest.raises(ValueError):
        ftt.gzip.compressor(io.BytesIO(), 0, **PORT_KW)


def test_flush_marker_equals_block_writer():
    sink = BitSink()
    j_block.write_flush_marker(sink)
    assert api.FLUSH_MARKER == sink.getvalue()


# ---- headers ----------------------------------------------------------------

@pytest.mark.parametrize("d", [b"", b"a", DICT, bytes(range(256)) * 130])
def test_zlib_dictionary_header_equal(d):
    got = containers.write_header(containers.Container.ZLIB, dictionary=d)
    assert got == j_containers.write_header(j_containers.Container.ZLIB,
                                            dictionary=d)
    assert (got[0] << 8 | got[1]) % 31 == 0 and got[1] & 0x20
    # the gzip and raw branches ignore the dictionary
    for kind in ("GZIP", "RAW"):
        assert containers.write_header(
            containers.Container[kind], dictionary=d) == \
            containers.write_header(containers.Container[kind])


@pytest.mark.parametrize("level", LEVELS)
def test_zlib_dictionary_stream_decodes(level):
    blob = ftt.zlib.compress(DATA, level, dictionary=DICT, **PORT_KW)
    assert blob[:6] == containers.write_header(containers.Container.ZLIB,
                                               dictionary=DICT)
    dec = zlib.decompressobj(zdict=DICT)
    assert dec.decompress(blob) == DATA and dec.eof


# ---- compress routes ---------------------------------------------------------

@pytest.mark.parametrize("ns", ["gzip", "zlib", "flate"])
@pytest.mark.parametrize("level", LEVELS)
def test_compress_reader_equal(ns, level):
    """A reader streams through the compressor, read batch x shard_len bytes
    at a time, into a writer."""
    jo, po = io.BytesIO(), io.BytesIO()
    assert J_NS[ns].compress(io.BytesIO(DATA), writer=jo, level=level,
                             opts=_opts(level), device=True) is None
    assert getattr(ftt, ns).compress(io.BytesIO(DATA), level, writer=po,
                                     **PORT_KW) is None
    assert po.getvalue() == jo.getvalue()
    assert zlib.decompress(po.getvalue(), WBITS[ns]) == DATA


@pytest.mark.parametrize("route", ["meta", "dictionary", "both"])
@pytest.mark.parametrize("level", LEVELS)
def test_compress_meta_dictionary_equal(level, route):
    meta = dict(filename=b"x.bin", mtime=7) if route != "dictionary" else None
    d = DICT if route != "meta" else None
    ns = "gzip" if route == "meta" else "zlib"
    want = J_NS[ns].compress(DATA, level=level, opts=_opts(level),
                             device=True, dictionary=d,
                             meta=_j_meta(**meta) if meta else None)
    got = getattr(ftt, ns).compress(DATA, level, dictionary=d,
                                    meta=_meta(**meta) if meta else None,
                                    **PORT_KW)
    assert got == want
    if ns == "gzip":
        assert pygz.decompress(got) == DATA
    else:
        assert zlib.decompressobj(zdict=d).decompress(got) == DATA


def test_compress_bytes_route_unchanged():
    """Bytes without meta or dictionary stay on compress_device2 (the FLT1
    index included), to a writer too."""
    kw = dict(shard_len=S, ctx=CTX, batch=BATCH)
    want = pipeline2.compress_device2(DATA, level=1, device="cpu", **kw)
    assert ftt.gzip.compress(DATA, 1, **PORT_KW) == want
    out = io.BytesIO()
    assert ftt.gzip.compress(memoryview(DATA), 1, writer=out,
                             **PORT_KW) is None
    assert out.getvalue() == want


# ---- the CLI ------------------------------------------------------------------

def test_cli_uses_compress(tmp_path, monkeypatch):
    """gzip_cli goes through flate_tpu_torch.gzip.compress (small shapes on
    the CPU here) and writes a member that gzip decodes; gunzip_cli reads
    it back through flate_tpu_torch.gzip.decompress, streaming the file to
    the output."""
    from flate_tpu_torch.cli import gunzip_cli, gzip_cli
    seen = {}
    orig, orig_d = ftt.gzip.compress, ftt.gzip.decompress

    def spy(data, level=6, *, writer=None, device="cuda", **kw):
        seen["compress"] = (level, device)
        return orig(data, level, writer=writer, **PORT_KW)

    def spy_d(data, writer=None, *, device="cuda", **kw):
        seen["decompress"] = device
        seen["streamed"] = not isinstance(data, bytes) and writer is not None
        return orig_d(data, writer, device="cpu")

    monkeypatch.setattr(ftt.gzip, "compress", spy)
    monkeypatch.setattr(ftt.gzip, "decompress", spy_d)
    p = tmp_path / "f.bin"
    p.write_bytes(DATA)
    assert gzip_cli.main(["-l", "1", "--device", "cpu", str(p)]) == 0
    assert seen["compress"] == (1, "cpu")
    blob = (tmp_path / "f.bin.gz").read_bytes()
    assert pygz.decompress(blob) == DATA
    assert blob == pipeline2.compress_device2(DATA, level=1, device="cpu",
                                              shard_len=S, ctx=CTX,
                                              batch=BATCH)
    p.unlink()
    assert gunzip_cli.main(["--device", "cpu",
                            str(tmp_path / "f.bin.gz")]) == 0
    assert seen["decompress"] == "cpu" and seen["streamed"]
    assert p.read_bytes() == DATA
    out = tmp_path / "o.bin"
    assert gunzip_cli.main(["--device", "cpu", "-o", str(out),
                            str(tmp_path / "f.bin.gz")]) == 0
    assert out.read_bytes() == DATA


def test_cli_default_device_is_cuda(tmp_path):
    from flate_tpu_torch.cli import gzip_cli
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is untestable")
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello")
    with pytest.raises(ftt.errors.DeviceUnavailable):
        gzip_cli.main([str(p)])
