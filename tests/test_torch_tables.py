"""The PyTorch port's copied state against the JAX package, value for value:
the level table, code tables, constants, fixed tables, host framing, the
arithmetic code functions, and the port's import and device rules."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from flate_tpu import checksums as j_checksums
from flate_tpu import consts as j_consts
from flate_tpu import containers as j_containers
from flate_tpu import errors as j_errors
from flate_tpu import inflate as j_inflate
from flate_tpu import shard_index as j_shard_index
from flate_tpu import tables as j_tables
from flate_tpu.jx import encode as j_encode
from flate_tpu.jx import encode2 as j_encode2
from flate_tpu.jx import header as j_header
from flate_tpu.jx import pipeline2 as j_pipeline2

import flate_tpu_torch
from flate_tpu_torch import checksums, consts, containers, errors, \
    shard_index, tables
from flate_tpu_torch import inflate as hinf
from flate_tpu_torch.device import encode, encode2, header, pipeline2


def test_level_kernel_table_equal():
    assert pipeline2.LEVEL_KERNEL == j_pipeline2.LEVEL_KERNEL


@pytest.mark.parametrize("name", [
    "MIN_MATCH_LEN", "MAX_MATCH_LEN", "MIN_DISTANCE", "MAX_DISTANCE",
    "HISTORY_LEN", "MAX_STORED_BLOCK", "SHARD_LEN", "NUM_LITLEN",
    "NUM_LITLEN_CODES", "NUM_DIST", "NUM_DIST_CODES", "NUM_CODEGEN",
    "END_OF_BLOCK", "MAX_CODE_BITS", "MAX_CODEGEN_BITS", "CODEGEN_ORDER",
    "HASH_MUL", "LEVEL_DEFAULT", "LOOKUP_BITS", "LEVEL_PARAMS", "LEVEL_FAST",
    "LEVEL_BEST"])
def test_consts_equal(name):
    assert getattr(consts, name) == getattr(j_consts, name)


@pytest.mark.parametrize("name", [
    "LENGTH_EXTRA_BITS", "LENGTH_BASE", "DIST_EXTRA_BITS", "DIST_BASE",
    "FIXED_LITLEN_LENS", "FIXED_DIST_LENS", "CODEGEN_ORDER",
    "FIXED_LITLEN_CODES", "FIXED_DIST_CODES", "LENGTH_TO_CODE",
    "DIST_TO_CODE"])
def test_tables_equal(name):
    a, b = getattr(tables, name), getattr(j_tables, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [
    "_FIX_LL_LENS", "_FIX_D_LENS", "_FIX_LL_PACKED", "_FIX_D_PACKED"])
def test_encode2_fixed_tables_equal(name):
    """The fixed tables come from the FULL 288/32 canonical assignment."""
    np.testing.assert_array_equal(
        getattr(encode2, name).astype(np.uint32),
        np.asarray(getattr(j_encode2, name)).astype(np.uint32))


def test_small_constants_equal():
    assert encode2._HYST == j_encode2._HYST
    assert header.HDR_SLOTS == j_header.HDR_SLOTS
    assert checksums.ADLER_MOD == j_checksums.ADLER_MOD
    np.testing.assert_array_equal(checksums.CRC_TABLE, j_checksums.CRC_TABLE)
    for S in (4096, 131072, 5 * 4096):
        for blk in (1024, 4096):
            seg = encode2.seg_size(S, blk)
            assert seg == j_encode2.seg_size(S, blk)
            assert encode2.slot_count(S, seg) == j_encode2.slot_count(S, seg)
            assert pipeline2._nwr(S, seg) == j_pipeline2._nwr(S, seg)


def test_combine_math_equal():
    rng = np.random.default_rng(3)
    for _ in range(20):
        a, b = (int(x) for x in rng.integers(0, 2**32, 2, dtype=np.uint64))
        n = int(rng.integers(0, 300000))
        assert checksums.crc32_combine(a, b, n) == \
            j_checksums.crc32_combine(a, b, n)
        assert checksums.adler32_combine(a, b, n) == \
            j_checksums.adler32_combine(a, b, n)


@pytest.mark.parametrize("meta", [None, "index", "full"])
@pytest.mark.parametrize("kind", ["GZIP", "ZLIB", "RAW"])
def test_container_framing_equal(kind, meta):
    extra = shard_index.build_index_extra([10, 20], [4096, 7], 1)
    assert extra == j_shard_index.build_index_extra([10, 20], [4096, 7], 1)
    m = jm = None
    if meta == "index":
        m = containers.GzipMetadata(extra=extra)
        jm = j_containers.GzipMetadata(extra=extra)
    elif meta == "full":
        kw = dict(filename=b"f.txt", comment=b"c", extra=extra, mtime=77,
                  text=True, hcrc=True)
        m = containers.GzipMetadata(**kw)
        jm = j_containers.GzipMetadata(**kw)
    c, jc = containers.Container[kind], j_containers.Container[kind]
    assert containers.write_header(c, m) == j_containers.write_header(jc, jm)
    h = containers.Hasher(c)
    jh = j_containers.Hasher(jc)
    assert h.chksum() == jh.chksum()
    h.value = jh.value = 0x12345678
    h.nbytes = jh.nbytes = 99
    assert containers.write_footer(c, h) == j_containers.write_footer(jc, jh)


ERROR_NAMES = [
    "FlateError", "EndOfStream", "BadGzipHeader", "BadZlibHeader",
    "WrongGzipChecksum", "WrongGzipSize", "WrongZlibChecksum", "InvalidCode",
    "InvalidMatch", "InvalidBlockType", "WrongStoredBlockNlen",
    "InvalidDynamicBlockHeader", "OversubscribedHuffmanTree",
    "IncompleteHuffmanTree", "MissingEndOfBlockCode", "UnfinishedBits"]


@pytest.mark.parametrize("name", ERROR_NAMES)
def test_error_taxonomy_equal(name):
    """Every error of the JAX package has its namesake, with the same
    bases by name."""
    a, b = getattr(errors, name), getattr(j_errors, name)
    assert [c.__name__ for c in a.__mro__] == [c.__name__ for c in b.__mro__]
    assert set(ERROR_NAMES) == {
        n for n in dir(j_errors)
        if isinstance(getattr(j_errors, n), type)}


def test_parse_index_extra_equal():
    extra = shard_index.build_index_extra([123, 45678, 1], [7168, 7168, 33], 1)
    for blob in (extra, b"XX\x03\x00abc" + extra, b"XX\x03\x00abc", b"",
                 extra[:-1], b"FT\x04\x00\x02\x00\x00\x00"):
        got = shard_index.parse_index_extra(blob)
        want = j_shard_index.parse_index_extra(blob)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[0].dtype == want[0].dtype and got[2] == want[2]


def _both(fn, jfn, *args):
    """(result or error class name) of the port's and the JAX package's
    function on the same arguments."""
    out = []
    for f in (fn, jfn):
        try:
            out.append(f(*args))
        except (errors.FlateError, j_errors.FlateError) as e:
            out.append(type(e).__name__)
    return out


GZ_FULL = j_containers.write_header(
    j_containers.Container.GZIP, j_containers.GzipMetadata(
        filename=b"f.txt", comment=b"c", extra=b"XX\x01\x00a", mtime=77,
        text=True, hcrc=True))
HEADERS = {
    "gzip_plain": ("GZIP", bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 3]) + b"z"),
    "gzip_full": ("GZIP", GZ_FULL + b"rest"),
    "gzip_bad_hcrc": ("GZIP", GZ_FULL[:-1] + bytes([GZ_FULL[-1] ^ 1])),
    "gzip_bad_magic": ("GZIP", b"\x1f\x8c" + GZ_FULL[2:]),
    "gzip_reserved_flag": ("GZIP", bytes([0x1F, 0x8B, 8, 0x20]) + b"\0" * 6),
    "gzip_short": ("GZIP", GZ_FULL[:7]),
    "gzip_cut_extra": ("GZIP", GZ_FULL[:13]),
    "gzip_cut_name": ("GZIP", GZ_FULL[:19]),
    "zlib_plain": ("ZLIB", b"\x78\x9c\x00"),
    "zlib_bad_check": ("ZLIB", b"\x78\x9d"),
    "zlib_fdict": ("ZLIB", b"\x78\xbb\x00\x00\x00\x01"),
    "zlib_short": ("ZLIB", b"\x78"),
    "raw": ("RAW", b"anything"),
}


@pytest.mark.parametrize("case", list(HEADERS))
def test_parse_header_equal(case):
    kind, data = HEADERS[case]
    c, jc = containers.Container[kind], j_containers.Container[kind]
    assert c.header_size == jc.header_size
    assert c.footer_size == jc.footer_size
    for allow in (False, True):
        got, want = _both(lambda d: containers.parse_header(c, d, allow),
                          lambda d: j_containers.parse_header(jc, d, allow),
                          data)
        if isinstance(want, str):
            assert got == want
            continue
        assert got[0] == want[0]
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            assert vars(got[1]) == vars(want[1])


@pytest.mark.parametrize("fault", [None, "checksum", "size", "short"])
@pytest.mark.parametrize("kind", ["GZIP", "ZLIB", "RAW"])
def test_parse_footer_equal(kind, fault):
    c, jc = containers.Container[kind], j_containers.Container[kind]
    data = b"some bytes " * 7000             # past the native-CRC threshold
    h, jh = containers.Hasher(c), j_containers.Hasher(jc)
    for part in (data[:100], data[100:]):
        h.update(part)
        jh.update(part)
    assert (h.chksum(), h.nbytes) == (jh.chksum(), jh.nbytes)
    foot = bytearray(containers.write_footer(c, h))
    if fault == "checksum" and foot:
        foot[0] ^= 1
    elif fault == "size" and kind == "GZIP":
        foot[5] ^= 1
    elif fault == "short":
        foot = foot[:-1]
    got, want = _both(lambda f: containers.parse_footer(c, f, h),
                      lambda f: j_containers.parse_footer(jc, f, jh),
                      bytes(foot))
    assert got == want


def test_host_checksums_equal():
    data = bytes(range(256)) * 300
    assert checksums.crc32(data) == j_checksums.crc32(data)
    assert checksums.adler32(data) == j_checksums.adler32(data)
    assert checksums.crc32(data[5:], 77) == j_checksums.crc32(data[5:], 77)
    assert checksums.adler32(data[5:], 77) == j_checksums.adler32(data[5:], 77)


@pytest.mark.parametrize("case", ["complete", "oversubscribed", "incomplete",
                                  "single", "empty", "no_eob"])
def test_check_completeness_equal(case):
    lens = np.zeros(286, np.int32)
    if case == "complete":
        lens[:256] = 9
        lens[256:] = 6              # 256/512 + 30/64 < 1: pad to complete
        lens[:4] = 8
        lens[4:8] = 7
    elif case == "oversubscribed":
        lens[:] = 7
    elif case == "incomplete":
        lens[250:260] = 9
    elif case == "single":
        lens[256] = 1
    elif case == "no_eob":
        lens[:4] = 2
    for is_ll in (True, False):
        got, want = _both(
            lambda l: hinf.check_completeness(l, 15, is_ll),
            lambda l: j_inflate.check_completeness(l, 15, is_ll), lens)
        assert got == want


def test_dynamic_header_and_block_decode_equal():
    """The host block loop: the dynamic header's code lengths, the decode
    tables and the decoded bytes of a zlib stream."""
    import zlib as pyzlib
    data = (DATA_TEXT * 2)[:50000]
    raw = pyzlib.compress(data, 9)[2:-4]
    a, b = hinf._BitCursor(raw), j_inflate._BitCursor(raw)
    assert (a.read(1), a.read(2)) == (b.read(1), b.read(2)) == (1, 2)
    la, lb = hinf.decode_dynamic_header_lens(a), \
        j_inflate.decode_dynamic_header_lens(b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    assert a.pos == b.pos
    for x, y in zip(hinf.build_decode_table(la[0], 15, True),
                    j_inflate.build_decode_table(lb[0], 15, True)):
        np.testing.assert_array_equal(x, y)
    out = bytearray()
    hinf._decode_coded_block(
        a, out, hinf.build_decode_table(la[0], 15, True),
        hinf.build_decode_table(la[1], 15, False))
    assert bytes(out) == data
    with pytest.raises(errors.EndOfStream):
        hinf._BitCursor(b"\x00").read(9)
    stored = hinf._BitCursor(b"\x05\x00\xfa\xffhello")
    sink = bytearray()
    hinf._decode_stored(stored, sink)
    assert bytes(sink) == b"hello"


DATA_TEXT = (pathlib.Path(__file__).parent / "data" / "rfc1951.txt"
             ).read_bytes()


def test_length_and_dist_codes_equal():
    lengths = np.arange(3, 259, dtype=np.int32)
    lc = j_encode.length_code(lengths)
    lev, leb = j_encode.length_extra(lengths, lc)
    t = torch.from_numpy(lengths)
    tc = encode.length_code(t)
    tev, teb = encode.length_extra(t, tc)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(lc))
    np.testing.assert_array_equal(tev.numpy(), np.asarray(lev))
    np.testing.assert_array_equal(teb.numpy(), np.asarray(leb))
    dists = np.arange(1, 32769, dtype=np.int32)
    dc = j_encode.dist_code(dists)
    dv, db = j_encode.dist_extra(dists, dc)
    t = torch.from_numpy(dists)
    tc = encode.dist_code(t)
    tv, tb = encode.dist_extra(t, tc)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(dc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(dv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(db))


def test_level_params():
    assert pipeline2.LEVEL_KERNEL == j_pipeline2.LEVEL_KERNEL
    for level in range(1, 10):
        p = pipeline2.level_params(level)
        K, nw, lazy, max_lazy, K3, sq, blk = j_pipeline2.LEVEL_KERNEL[level]
        assert p == dict(K=K, nw=nw, lazy=lazy, max_lazy=max_lazy, K3=K3,
                         squeeze=sq, blk=blk)
        assert sq == (level not in (1, 3))
    # the parse block is fitted to a small shard
    assert pipeline2.level_params(9, 4096)["blk"] == 4096
    assert pipeline2.level_params(9, 5120)["blk"] == 1024
    for level in (0, 10, -1):
        with pytest.raises(ValueError):
            pipeline2.level_params(level)


def test_round1_level_knobs():
    """The round-1 encoder's phase1 knobs follow the JAX package's level
    table (jx/pipeline.py:294, :326-327)."""
    from flate_tpu_torch.device import pipeline
    for level in range(1, 10):
        K, _nice, lazy, max_lazy = j_consts.LEVEL_PARAMS[level]
        assert pipeline.level_knobs(level) == dict(
            K=K, K3=min(8, K), lazy=lazy, max_lazy=max_lazy,
            nwords=16 if level >= 6 else 8)
    for level in (0, 10, -2):
        with pytest.raises(ValueError):
            pipeline.level_knobs(level)


def test_cuda_default_raises_without_card():
    """The entry points run on "cuda" unless told otherwise, and raise when
    there is no card rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule is untestable")
    with pytest.raises(errors.DeviceUnavailable):
        flate_tpu_torch.gzip.compress(b"hello", level=1)
    with pytest.raises(errors.DeviceUnavailable):
        pipeline2.compress_device2(b"hello", level=1, device="cuda")


def test_library_name_follows_source_and_headers(tmp_path):
    """A kernel library is named by the hash of its source and of the
    headers beside it, so an edited header is rebuilt too."""
    from flate_tpu_torch import _build
    src = tmp_path / "k.cu"
    head = tmp_path / "h.cuh"
    src.write_text('#include "h.cuh"\n')
    head.write_text("// one\n")
    first = _build._library_path(src)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk_")
    head.write_text("// two\n")
    second = _build._library_path(src)
    src.write_text('#include "h.cuh"  \n')
    assert len({first, second, _build._library_path(src)}) == 3
    assert all(_build._library_path(s) == _build._library_path(s)
               for s in _build.SOURCES)


def test_port_imports_no_jax_and_no_flate_tpu():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import flate_tpu_torch, flate_tpu_torch.api, flate_tpu_torch._build\n"
        "import flate_tpu_torch.inflate\n"
        "import flate_tpu_torch.cli.gzip_cli, flate_tpu_torch.cli.gunzip_cli\n"
        "import flate_tpu_torch.cli.roundtrip_cli\n"
        "import flate_tpu_torch.cli.decompress_cli, flate_tpu_torch.metrics\n"
        "from flate_tpu_torch.device import anyinflate, bitonic, checksum, "
        "encode, encode2, header, huff, inflate2, match2, onehot, pack, "
        "parse, pipeline, pipeline2, runs, scan, squeeze\n"
        "from flate_tpu_torch.device import match\n"
        "from flate_tpu_torch import bitpack, block, deflate, huffman\n"
        "from flate_tpu_torch.parallel import pigz\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or "
        "m.startswith('jax.') or m == 'flate_tpu' or "
        "m.startswith('flate_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/lane_join_probe.py",
                                    "tools/torch_bitonic_probe.py",
                                    "tools/torch_kernel_probe.py",
                                    "flate_tpu_torch/cli/gzip_cli.py",
                                    "flate_tpu_torch/cli/gunzip_cli.py"])
def test_card_scripts_import_no_jax_and_no_flate_tpu(script):
    """The card scripts run where there is no JAX: every import statement
    in them, at any depth, names neither jax nor flate_tpu."""
    path = pathlib.Path(__file__).resolve().parents[1] / script
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "flate_tpu_torch" in {n.split(".")[0] for n in names} or \
        "chip_smoke" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "flate_tpu")]
    assert not bad, bad
