"""The port's roundtrip and decompress CLIs through main() on the CPU,
against the JAX package's (flate_tpu/cli/roundtrip_cli.py,
decompress_cli.py): the same exit codes (0 OK, 1 a protocol error, 2 the
decoders disagree) and the same first word and number printed.
"""

import functools
import io
import sys
import types
import zlib

import pytest
import torch

from flate_tpu.cli import decompress_cli as j_decompress_cli

import flate_tpu_torch as ftt
from flate_tpu_torch.cli import decompress_cli, roundtrip_cli

from _torch_corpora import corpus, small_blocks, too_far_streams

SMALL = dict(shard_len=4096, ctx=1024, batch=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, data: bytes, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin",
                        types.SimpleNamespace(buffer=io.BytesIO(data)))
    rc = main(argv) if argv is not None else main()
    return rc, capsys.readouterr()


def _raw(data: bytes, level: int = 6) -> bytes:
    return zlib.compress(data, level)[2:-4]


TEXT = corpus("mixed", 5000, seed=51)
RAW_CASES = {
    "ok": _raw(TEXT),
    "empty_stream": _raw(b""),
    "small_blocks": small_blocks(TEXT, -15),
    "two_streams": _raw(TEXT[:3000]) + _raw(TEXT[3000:], 1),
    "truncated": _raw(TEXT)[:-40],
    "too_far": too_far_streams()["RAW"],
    "bad_type": b"\xff\xff",
    "trailing_ff": _raw(TEXT) + b"\xff",
    "no_input": b"",
}
# The JAX CLI's decoders read one raw stream and ignore the bytes after
# it; the port's read stream after stream, as the public decode does.
MULTI = {"two_streams": (0, ["OK", str(len(TEXT))]),
         "trailing_ff": (1, ["ERR", "InvalidBlockType"]),
         "no_input": (0, ["OK", "0"])}


@pytest.mark.parametrize("name", sorted(RAW_CASES))
def test_decompress_cli_as_jax(name, monkeypatch, capsys):
    data = RAW_CASES[name]
    rc, out = _run(decompress_cli.main, data, ["--device", "cpu"],
                   monkeypatch, capsys)
    j_rc, j_out = _run(j_decompress_cli.main, data, None, monkeypatch,
                       capsys)
    want = MULTI.get(name, (j_rc, j_out.out.split()))
    assert (rc, out.out.split()) == want, out.err


def test_decompress_cli_flags_disagreement(monkeypatch, capsys):
    orig = ftt.flate.decompressor

    def off_by_one(data, *a, **kw):
        return orig(data[:-1], *a, **kw)

    monkeypatch.setattr(ftt.flate, "decompressor", off_by_one)
    rc, out = _run(decompress_cli.main, RAW_CASES["ok"], ["--device", "cpu"],
                   monkeypatch, capsys)
    assert rc == 2 and "DISAGREE stream" in out.err


def test_roundtrip_cli(monkeypatch, capsys):
    monkeypatch.setattr(ftt.flate, "compress", functools.partial(
        ftt.flate.compress, **SMALL))
    rc, out = _run(roundtrip_cli.main, TEXT[:5000], ["--device", "cpu"],
                   monkeypatch, capsys)
    assert (rc, out.out.split()) == (0, ["OK"])


@pytest.mark.parametrize("mode", ["level", "store"])
def test_roundtrip_cli_fails_on_a_bad_mode(mode, monkeypatch, capsys):
    compress = functools.partial(ftt.flate.compress, **SMALL)
    if mode == "level":
        monkeypatch.setattr(ftt.flate, "compress",
                            lambda data, level, **kw: compress(data[1:],
                                                               level, **kw))
    else:
        monkeypatch.setattr(ftt.flate, "compress", compress)
        orig = ftt.flate.store.compress
        monkeypatch.setattr(ftt.flate.store, "compress",
                            lambda data: orig(data[1:]))
    rc, out = _run(roundtrip_cli.main, TEXT[:3000], ["--device", "cpu"],
                   monkeypatch, capsys)
    want = "FAIL level 1" if mode == "level" else "FAIL store"
    assert rc == 1 and want in out.err


def test_cli_default_device_is_cuda(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for main in (decompress_cli.main, roundtrip_cli.main):
        with pytest.raises(ftt.errors.DeviceUnavailable):
            _run(main, RAW_CASES["ok"], [], monkeypatch, capsys)
