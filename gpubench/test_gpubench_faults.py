"""Each cell, driven by the harness on the CPU at a small size, is correct
as it stands, and is not correct under its control or with the timed path
broken underneath it: an answer altered where it is produced, half of the
work left out, and a state left unchanged (the answer of the call before).
A card-only test runs each cell on the card for a short window."""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from gpubench import harness, registry

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SMALL_CONFIG = {"shard_len": 16384, "ctx": 4096, "encode_batch": 2,
                "file_bytes": 98304}
# the streaming decoder's windows, shrunk as the program's tests shrink
# them, so a stream takes many steps; the bounds the configuration states
# follow them
WINDOW, FETCH, TRIM = 8192, 3000, 16384


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cell, monkeypatch, control=False, seed=2**31 + 99):
    from flate_tpu_torch import api
    bench = registry.benchmark()
    cfg = dict(SMALL_CONFIG)
    mix = {}
    if registry.mix(registry.cell(bench, cell)["traffic"])["op"] \
            == "decompressor":
        for name, v in (("WINDOW", WINDOW), ("FETCH", FETCH),
                        ("TRIM", TRIM)):
            monkeypatch.setattr(api.Decompressor, name, v)
        base = registry.config(bench, registry.cell(bench, cell)["config"])
        cfg["guarantees"] = {**base["guarantees"],
                             "input_peak_bytes": TRIM + WINDOW + FETCH}
        cfg["control_window"] = 1 << 20
        mix["read_bytes"] = 4099
    return harness.run_cell(bench, cell, seed, 0.3, False, "cpu",
                            time.perf_counter(), control=control,
                            overrides={"config": cfg, "mix": mix})


def break_path(cell, monkeypatch, fault):
    """Break the program underneath the harness: `fault` is "altered",
    "half" or "unchanged"."""
    from flate_tpu_torch import api
    from flate_tpu_torch.device import pipeline2
    op = registry.mix(registry.cell(registry.benchmark(), cell)
                      ["traffic"])["op"]
    last = {}

    def flip(b: bytes) -> bytes:
        i = len(b) // 2
        return b[:i] + bytes([b[i] ^ 0x5A]) + b[i + 1:]

    def wrap(fn, halve_input):
        def broken(data, *a, **kw):
            if fault == "half" and halve_input:
                return fn(data[:len(data) // 2], *a, **kw)
            out = fn(data, *a, **kw)
            if fault == "altered":
                return flip(out)
            if fault == "half":
                return out[:len(out) // 2]
            prev = last.get("out", out)        # the state left unchanged
            last["out"] = out
            return prev
        return broken

    if op == "compress":
        monkeypatch.setattr(pipeline2, "compress_device2",
                            wrap(pipeline2.compress_device2, True))
    elif op == "decompress":
        monkeypatch.setattr(api, "decode_members",
                            wrap(api.decode_members, False))
    else:
        read = api.Decompressor.read

        def broken_read(self, n=-1):
            chunk = read(self, n)
            if not chunk:
                return chunk
            if fault == "altered":
                return flip(chunk)
            if fault == "half":
                return chunk[:len(chunk) // 2]
            prev = last.get("chunk", chunk)
            last["chunk"] = chunk
            return prev
        monkeypatch.setattr(api.Decompressor, "read", broken_read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell, monkeypatch):
    r = run(cell, monkeypatch)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, monkeypatch):
    r = run(cell, monkeypatch, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    break_path(cell, monkeypatch, fault)
    r = run(cell, monkeypatch)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    """One short run of the cell as the driver starts it."""
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         str(2**31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env={k: v for k, v in os.environ.items() if k != "BENCH_RUN"})
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
