"""End to end: the port's compress_device2 (device="cpu") against
flate_tpu.jx.pipeline2.compress_device2(interpret=True), byte for byte at
every level, and zlib decodes it back to the input.

Levels 8 and 9 (K = 96 / 160 with 16 carry words) take minutes each to
trace in interpret mode and are marked slow; level 7 holds their code path
(4 KiB parse blocks, the 3-byte K3 pass) in the fast tier, and the port's
bytes of the slow cases are held there to the sha256 of the JAX bytes
(SQUEEZE_PINS)."""

import hashlib
import zlib

import numpy as np
import pytest
import torch

from flate_tpu.containers import Container as JContainer
from flate_tpu.jx import pipeline2 as j_pipeline2

import flate_tpu_torch
from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import pipeline2

from _torch_corpora import CTX, S, corpus

WBITS = {"GZIP": 31, "ZLIB": 15, "RAW": -15}

torch.set_num_threads(1)         # the squeeze DP is thousands of tiny ops


def _both(data, level, container="GZIP", independent=False, batch=2):
    kw = dict(level=level, shard_len=S, ctx=CTX, batch=batch,
              independent=independent)
    ref = j_pipeline2.compress_device2(
        data, container=JContainer[container], interpret=True, **kw)
    out = pipeline2.compress_device2(data, container=Container[container],
                                     device="cpu", **kw)
    return ref, out


def _check(data, ref, out, container="GZIP"):
    assert out == ref, (len(out), len(ref))
    assert zlib.decompress(out, WBITS[container]) == data


@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("container", ["GZIP", "ZLIB", "RAW"])
@pytest.mark.parametrize("level", [1, 3, 6])
def test_compress_device2_equal(level, container, independent):
    """rfc1951 text over two batches with a tail shard: the context carry
    from batch to batch, the FLT1 index and every container."""
    data = corpus("text", 3 * S + 333, seed=1)
    ref, out = _both(data, level, container, independent)
    _check(data, ref, out, container)


@pytest.mark.parametrize("kind", ["random", "runs", "mixed"])
@pytest.mark.parametrize("level", [1, 3, 6])
def test_corpora_equal(level, kind):
    data = corpus(kind, 5 * S - 1000, seed=7)
    ref, out = _both(data, level)
    _check(data, ref, out)


# sha256 of the JAX bytes of test_squeeze_levels_equal's slow cases
SQUEEZE_PINS = {
    (8, "mixed"):
        "d26238f0ed74ffc587eb757f225cb93b9b13e96696363af2486f2cb3a9d300e7",
    (9, "text"):
        "5cf67b5eb9ebfec50d10361ce754b88c5a204510ee1ba3cd08a60d7af80fbe9e",
}


@pytest.mark.parametrize("level,kind", [
    (2, "text"), (4, "mixed"), (5, "runs"), (7, "text"),
    pytest.param(8, "mixed", marks=pytest.mark.slow),
    pytest.param(9, "text", marks=pytest.mark.slow)])
def test_squeeze_levels_equal(level, kind):
    """The other levels that run the cost DP, one corpus each, over two
    batches with a tail shard."""
    data = corpus(kind, 3 * S + 333, seed=level)
    ref, out = _both(data, level)
    _check(data, ref, out)
    if (level, kind) in SQUEEZE_PINS:
        assert hashlib.sha256(ref).hexdigest() == SQUEEZE_PINS[level, kind]


@pytest.mark.parametrize("level,kind", list(SQUEEZE_PINS))
def test_squeeze_levels_equal_pin(level, kind):
    data = corpus(kind, 3 * S + 333, seed=level)
    out = pipeline2.compress_device2(data, level=level, shard_len=S, ctx=CTX,
                                     batch=2, device="cpu")
    assert hashlib.sha256(out).hexdigest() == SQUEEZE_PINS[level, kind]
    assert zlib.decompress(out, 31) == data


def test_squeeze_knobs_follow_the_environment(monkeypatch):
    """FLATE_TPU_SQUEEZE_GRID and _HIST_STRIDE are read per call (the JAX
    package reads them at import): another parse, still a valid stream."""
    data = corpus("text", 2 * S, seed=5)
    kw = dict(level=6, shard_len=S, ctx=CTX, batch=2, device="cpu")
    base = pipeline2.compress_device2(data, **kw)
    monkeypatch.setenv("FLATE_TPU_SQUEEZE_GRID", "1")
    grid = pipeline2.compress_device2(data, **kw)
    monkeypatch.setenv("FLATE_TPU_SQUEEZE_HIST_STRIDE", "4")
    both = pipeline2.compress_device2(data, **kw)
    assert len({base, grid, both}) == 3
    for out in (grid, both):
        assert zlib.decompress(out, 31) == data


@pytest.mark.parametrize("n", [0, 1, 20, 147, 301])
def test_tiny_inputs_equal(n):
    """Empty and tiny inputs; bytes >= 128 pick fixed blocks with the 9-bit
    literal codes."""
    rng = np.random.default_rng(1234 + n)
    data = rng.integers(128, 256, n, dtype=np.uint8).tobytes()
    ref, out = _both(data, 1, "RAW", independent=True)
    _check(data, ref, out, "RAW")


def test_api_namespaces():
    data = corpus("mixed", 2 * S + 5, seed=3)
    for ns, container in ((flate_tpu_torch.gzip, "GZIP"),
                          (flate_tpu_torch.zlib, "ZLIB"),
                          (flate_tpu_torch.flate, "RAW")):
        out = ns.compress(data, level=3, device="cpu", shard_len=S, batch=2)
        assert zlib.decompress(out, WBITS[container]) == data
        blob = ns.compress(data, level=6, device="cpu", shard_len=S, batch=2)
        assert zlib.decompress(blob, WBITS[container]) == data
        assert ns.decompress(blob, device="cpu", batch=2) == data
    with pytest.raises(ValueError, match="invalid level"):
        flate_tpu_torch.gzip.compress(data, level=10, device="cpu")
