"""The port's metrics module against the JAX package's (flate_tpu/metrics.py,
tests/test_metrics.py): the same functions, op names and environment
variable, recorded at the same places, on the CPU.  Tolerance: exact
(counts and byte totals).
"""

import gzip as pygzip
import inspect
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from flate_tpu import metrics as j_metrics

import flate_tpu_torch as ftt
from flate_tpu_torch import metrics
from flate_tpu_torch.device import anyinflate, inflate2, pipeline2

from _torch_corpora import corpus

SMALL = dict(device="cpu", shard_len=4096, ctx=1024, batch=2)
DATA = corpus("text", 20_000, seed=41)


@pytest.fixture(autouse=True)
def _enabled():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    metrics.enable()
    yield
    metrics.disable()
    metrics.reset()
    torch.set_num_threads(n)


def test_same_functions_as_jax():
    for name in ("enable", "disable", "reset", "enabled", "record", "timed",
                 "records", "summary"):
        assert inspect.signature(getattr(metrics, name)) \
            == inspect.signature(getattr(j_metrics, name)), name


def test_compress_decompress_recorded():
    blob = ftt.gzip.compress(DATA, 6, **SMALL)
    assert ftt.gzip.decompress(blob, device="cpu") == DATA
    s = metrics.summary()
    c, d = s["gzip.compress"], s["gzip.decompress"]
    assert c["calls"] == 1 and c["bytes_in"] == len(DATA)
    assert c["bytes_out"] == len(blob)
    assert d["bytes_in"] == len(blob) and d["bytes_out"] == len(DATA)
    assert c["gbps"] > 0 and d["gbps"] > 0
    assert s["device.compress"]["bytes_out"] == len(blob)
    assert s["device.decompress_indexed"]["bytes_out"] == len(DATA)


def test_disabled_records_nothing():
    metrics.disable()
    ftt.gzip.compress(DATA[:1024], 1, **SMALL)
    assert metrics.summary() == {}


def test_device_pipeline_recorded():
    blob = pipeline2.compress_device2(DATA, level=1, shard_len=8192,
                                      ctx=1024, batch=2, device="cpu")
    s = metrics.summary()
    assert s["device.compress"]["bytes_in"] == len(DATA)
    assert s["device.compress"]["bytes_out"] == len(blob)
    assert metrics.records()[-1]["level"] == 1


def test_device_decodes_recorded_by_route():
    """An indexed member and a foreign one: a record on each route, per
    member through the api and per stream through the device functions."""
    own = ftt.gzip.compress(DATA, 1, **SMALL)
    foreign = pygzip.compress(DATA)
    assert ftt.gzip.decompress(own + foreign, device="cpu") == DATA * 2
    s = metrics.summary()
    assert s["device.decompress_indexed"]["bytes_in"] == len(own)
    assert s["device.decompress_any"]["bytes_in"] == len(foreign)
    assert s["gzip.decompress"]["bytes_out"] == 2 * len(DATA)
    metrics.reset()
    inflate2.decompress_device(own, batch=2, device="cpu")
    anyinflate.decompress_device_any(foreign, device="cpu")
    s = metrics.summary()
    assert s["device.decompress_indexed"]["calls"] == 1
    assert s["device.decompress_any"]["bytes_out"] == len(DATA)


def test_huffman_and_streaming_recorded():
    import io
    blob = ftt.zlib.huffman.compress(DATA)
    assert metrics.records()[-1]["mode"] == "huffman"
    out = io.BytesIO()
    ftt.zlib.decompress(io.BytesIO(blob), out, device="cpu")
    s = metrics.summary()
    assert s["zlib.compress"]["bytes_out"] == len(blob)
    assert s["zlib.decompress"]["calls"] == 1


def test_environment_variable_enables():
    code = ("import flate_tpu_torch as ftt; "
            "print(ftt.metrics.enabled())")
    for value, want in (("1", "True"), ("", "False")):
        env = {**os.environ, "FLATE_TPU_METRICS": value}
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True,
                             cwd=pathlib.Path(__file__).parent.parent)
        assert out.stdout.strip() == want
