"""The port's stage spans (flate_tpu_torch.metrics.span / spans): when they
record, how they nest, the bounded buffer, the stages of an encode and of
each decode route, and the clock they share with torch.profiler's trace.
On the CPU at small shapes; the clock on the card is the `cuda` test at the
end (`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_spans.py`)."""

import collections
import gzip as pygzip
import io
import json
import pathlib
import re
import subprocess
import sys
import zlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import flate_tpu_torch as ftt
from flate_tpu_torch import metrics
from flate_tpu_torch.device import inflate2

from _torch_corpora import corpus

SMALL = dict(device="cpu", shard_len=4096, ctx=1024, batch=2)
DATA = corpus("text", 20_000, seed=43)
ENCODE_STAGES = ["encode.dispatch", "encode.match", "encode.match.main",
                 "encode.match.extend", "encode.parse",
                 "encode.squeeze", "encode.squeeze.lengths",
                 "encode.squeeze.dp", "encode.fields", "encode.pack",
                 "encode.compact"]
LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|cuLaunchKernel"
                    r"|cuLaunchKernelEx)(_v\d+|_ptsz)?$")


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.disable()
    metrics.reset()
    yield
    metrics.disable()
    metrics.reset()
    torch.set_num_threads(n)


def names(spans=None) -> list:
    return [s["name"] for s in (metrics.spans() if spans is None else spans)]


def by_id(spans) -> dict:
    return {s["id"]: s for s in spans}


def test_nothing_recorded_when_off():
    with metrics.span("a", x=1) as attrs:
        attrs["y"] = 2
    ftt.gzip.compress(DATA[:3000], 1, **SMALL)
    assert metrics.spans() == [] and metrics.records() == []


def test_recorded_when_enabled_or_profiled():
    metrics.enable()
    with metrics.span("a", x=1) as attrs:
        attrs["y"] = 2
    metrics.disable()
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("b"):
            pass
    with metrics.span("c"):
        pass
    (a, b) = metrics.spans()
    assert (a["name"], a["attrs"], b["name"]) == ("a", {"x": 1, "y": 2}, "b")
    assert a["start_ns"] <= a["end_ns"] <= b["start_ns"] <= b["end_ns"]
    # the profiler alone records spans, not the op records
    assert metrics.records() == []


def test_parents_calls_and_errors():
    metrics.enable()
    with metrics.span("root"):
        with metrics.span("child"):
            with metrics.span("leaf"):
                pass
        with pytest.raises(KeyError):
            with metrics.span("failed"):
                raise KeyError
    with metrics.span("second"):
        pass
    sp = {s["name"]: s for s in metrics.spans()}
    root = sp["root"]
    assert root["parent"] is None and root["call"] == root["id"]
    assert sp["child"]["parent"] == root["id"]
    assert sp["leaf"]["parent"] == sp["child"]["id"]
    assert sp["failed"]["parent"] == root["id"]
    assert sp["failed"]["attrs"] == {"error": "KeyError"}
    assert {sp[k]["call"] for k in ("child", "leaf", "failed")} \
        == {root["id"]}
    assert sp["second"]["parent"] is None \
        and sp["second"]["call"] == sp["second"]["id"] != root["id"]
    for k in ("child", "failed"):
        assert root["start_ns"] <= sp[k]["start_ns"] \
            <= sp[k]["end_ns"] <= root["end_ns"]
    # spans() hands out copies
    metrics.spans()[0]["attrs"]["z"] = 1
    assert "z" not in metrics.spans()[0]["attrs"]


def test_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(metrics, "_spans", collections.deque(maxlen=4))
    metrics.enable()
    for i in range(7):
        with metrics.span("s", i=i):
            pass
    assert [s["attrs"]["i"] for s in metrics.spans()] == [3, 4, 5, 6]
    assert metrics.spans_dropped() == 3
    metrics.reset()
    assert metrics.spans() == [] and metrics.spans_dropped() == 0


def test_ops_are_roots_records_unchanged():
    """timed() opens a span under its op name: the public call is the
    root, the device op beneath it; the op records are as they were."""
    metrics.enable()
    blob = ftt.gzip.compress(DATA, 6, **SMALL)
    sp = metrics.spans()
    ids = by_id(sp)
    root, dev = sp[0], sp[1]
    assert (root["name"], dev["name"]) == ("gzip.compress", "device.compress")
    assert dev["parent"] == root["id"]
    assert all(s["call"] == root["id"] for s in sp)
    assert root["attrs"] == {"bytes_in": len(DATA), "level": 6,
                             "mode": "deflate"}
    for s in sp[2:]:
        assert ids[s["parent"]]["name"] in ("device.compress",
                                            "encode.dispatch",
                                            "encode.match",
                                            "encode.squeeze")
    assert [r["op"] for r in metrics.records()] \
        == ["device.compress", "gzip.compress"]
    assert metrics.records()[1]["bytes_out"] == len(blob)


def test_encode_stages_once_a_batch_in_order():
    """Five batches of 2 shards: each stage span once a batch, in the
    order of the stages, under that batch's dispatch; each batch fetched
    and folded once, then the member assembled."""
    metrics.enable()
    data = corpus("text", 9 * 4096 + 100, seed=45)
    blob = ftt.gzip.compress(data, 6, **SMALL)
    assert pygzip.decompress(blob) == data
    sp = metrics.spans()
    ids = by_id(sp)
    dispatch = [s for s in sp if s["name"] == "encode.dispatch"]
    assert [s["attrs"] for s in dispatch] == [
        {"batch": b, "shards": 2} for b in range(5)]
    for d in dispatch:
        inside = [s for s in sp if s["parent"] == d["id"]
                  or s["parent"] in ids and ids[s["parent"]]["parent"]
                  == d["id"]]
        assert names(inside) == ENCODE_STAGES[1:]
    for stage in ENCODE_STAGES:
        assert names().count(stage) == 5, stage
    for stage in ("encode.fetch", "encode.fold"):
        assert [s["attrs"]["batch"] for s in sp if s["name"] == stage] \
            == list(range(5))
    assert names()[-1] == "encode.assemble"


def test_indexed_decode_stages():
    blob = ftt.gzip.compress(DATA, 1, **SMALL)
    metrics.enable()
    assert ftt.gzip.decompress(blob, device="cpu", batch=2) == DATA
    sp = metrics.spans()
    ids = by_id(sp)
    assert names(sp)[:3] == ["gzip.decompress", "device.decompress_indexed",
                             "decode.index"]
    nb = names(sp).count("decode.batch")
    assert nb == -(-len(DATA) // 4096 // 2) and "decode.retry" not in names()
    for stage in ("decode.plan", "decode.upload", "decode.flags",
                  "decode.fetch"):
        assert names(sp).count(stage) == nb, stage
    for s in sp:
        if s["name"] in ("decode.pass1", "decode.lane_walk",
                         "decode.extract", "decode.resolve"):
            assert ids[s["parent"]]["name"] == "decode.batch"
    up = [s for s in sp if s["name"] == "decode.upload"]
    assert sum(s["attrs"]["shards"] for s in up) == -(-len(DATA) // 4096)
    # one checksum span a batch and the footer's
    assert names(sp).count("decode.checksum") == nb + 1


def test_forced_serial_retry_gives_its_span(monkeypatch):
    """Every lane walk reported unproven: each batch is walked again
    serially, in a decode.retry span, and the bytes stay right."""
    real = inflate2.decode_batch2

    def unproven(*args, **kw):
        out, err, counts, spec_fail, *rest = real(*args, **kw)
        return (out, err, counts, torch.ones_like(spec_fail), *rest)

    monkeypatch.setattr(inflate2, "decode_batch2", unproven)
    blob = ftt.gzip.compress(DATA, 1, **SMALL)
    metrics.enable()
    assert ftt.gzip.decompress(blob, device="cpu", batch=2) == DATA
    sp = metrics.spans()
    ids = by_id(sp)
    retries = [s for s in sp if s["name"] == "decode.retry"]
    assert len(retries) == names(sp).count("decode.batch") > 0
    for r in retries:
        kids = [s["name"] for s in sp if s["parent"] == r["id"]]
        assert kids == ["decode.pass1", "decode.walk", "decode.resolve",
                        "decode.flags"]
        assert ids[r["parent"]]["name"] == "device.decompress_indexed"


def test_chained_decode_stages():
    stream = zlib.compress(DATA, 6)
    metrics.enable()
    assert ftt.zlib.decompress(stream, device="cpu") == DATA
    sp = metrics.spans()
    ids = by_id(sp)
    # the indexed route looks for an index first, then the chains
    assert names(sp)[:4] == ["zlib.decompress", "device.decompress_indexed",
                             "decode.index", "device.decompress_any"]
    assert sp[1]["attrs"]["error"] == "LookupError"
    member = sp[3]
    rounds = [s for s in sp if s["name"] == "chain.round"]
    assert rounds and all(s["attrs"]["rows"] >= 1
                          and s["attrs"]["span_c"] >= 8192 for s in rounds)
    assert names(sp).count("chain.plan") == names(sp).count("chain.link") \
        >= len(rounds)
    for s in sp[4:]:
        assert s["parent"] == member["id"], s["name"]
    assert names(sp)[4] == "chain.scan"
    assert "chain.resolve" in names(sp) and names(sp)[-1] == "decode.checksum"
    assert len({s["call"] for s in sp}) == 1


def test_decompressor_steps_and_reads():
    data = corpus("mixed", 40_000, seed=46)
    stream = zlib.compress(data, 6)
    metrics.enable()
    d = ftt.zlib.decompressor(io.BytesIO(stream), device="cpu")
    d.WINDOW = 8192
    parts = []
    while chunk := d.read(5000):
        parts.append(chunk)
    assert b"".join(parts) == data
    sp = metrics.spans()
    ids = by_id(sp)
    reads = [s for s in sp if s["name"] == "stream.read"]
    steps = [s for s in sp if s["name"] == "stream.step"]
    assert len(reads) == len(parts) + 1 and all(
        s["parent"] is None and s["call"] == s["id"] for s in reads)
    assert len(steps) == d.stats["steps"] > 1
    assert [s["attrs"]["step"] for s in steps] == list(range(len(steps)))
    for s in steps:
        assert ids[s["parent"]]["name"] == "stream.read"
    for s in sp:
        if s["name"] in ("chain.scan", "chain.plan", "chain.round",
                         "chain.link"):
            assert ids[s["parent"]]["name"] == "stream.step"
        if s["name"] == "chain.resolve":
            assert ids[s["parent"]]["name"] in ("stream.read",
                                                "stream.step")


def test_span_clock_is_the_profilers():
    """A span opened inside a record_function range under the profiler
    lies within that range's interval in the trace: the spans and the
    trace's host events share one clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(50):
            with record_function(f"clock_probe_{i}"):
                with metrics.span("probe", i=i):
                    torch.ones(64).add_(1)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock_probe_"):
            ranges[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    sp = metrics.spans()
    assert len(sp) == 50 and len(ranges) == 50
    for s in sp:
        lo, hi = ranges[f"clock_probe_{s['attrs']['i']}"]
        assert lo <= s["start_ns"] <= s["end_ns"] <= hi, (lo, s, hi)


def device_lead_ns(prof) -> int:
    """How far the trace's device timeline runs ahead of its host events:
    the most that a kernel starts before its own launch call (0 when
    none does).  Kineto converts the two clocks apart; on the card a kernel
    that runs at once can read a few µs before its launch."""
    events = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if "CPU" in str(e.device_type()) and LAUNCH.match(e.name())}
    return max([0] + [launch[e.correlation_id()] - e.start_ns()
                      for e in events if "CUDA" in str(e.device_type())
                      and e.correlation_id() in launch])


def squeeze_kernels_outside(prof, spans, slack_ns: int = 0
                            ) -> tuple[int, list]:
    """The kernels that the launches inside each encode.squeeze span
    started (matched by correlation id), and those of them that do not lie
    between the span's start and the end of the encode.fetch span that
    waits for its batch, widened by `slack_ns` on each side: (kernels,
    [(kernel, start, end, span start, fetch end), ...])."""
    ids = by_id(spans)
    fetch_end = {(s["call"], s["attrs"]["batch"]): s["end_ns"]
                 for s in spans if s["name"] == "encode.fetch"}
    squeeze = []
    for s in spans:
        if s["name"] == "encode.squeeze":
            batch = ids[s["parent"]]["attrs"]["batch"]
            squeeze.append((s["start_ns"], s["end_ns"],
                            fetch_end[(s["call"], batch)]))
    events = list(prof.profiler.kineto_results.events())
    owner = {}
    for e in events:
        if "CPU" in str(e.device_type()) and LAUNCH.match(e.name()):
            t = e.start_ns()
            for lo, hi, end in squeeze:
                if lo <= t < hi:
                    owner[e.correlation_id()] = (lo, end)
    n, outside = 0, []
    for e in events:
        if "CUDA" in str(e.device_type()) and e.correlation_id() in owner:
            lo, end = owner[e.correlation_id()]
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            n += 1
            if not lo - slack_ns <= s <= t <= end + slack_ns:
                outside.append((e.name(), s, t, lo, end))
    return n, outside


def card_clock_check(data: bytes, **kw) -> dict:
    """Encode `data` at level 6 on the card once to warm, then once under
    torch.profiler (CPU and CUDA), and hold the squeeze's kernels to their
    spans: exactly, and within the trace's own device lead."""
    ftt.gzip.compress(data, 6, device="cuda", **kw)
    torch.cuda.synchronize()
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ftt.gzip.compress(data, 6, device="cuda", **kw)
        torch.cuda.synchronize()
    sp = metrics.spans()
    lead = device_lead_ns(prof)
    n, outside = squeeze_kernels_outside(prof, sp)
    _, beyond = squeeze_kernels_outside(prof, sp, lead)
    dp = sum(1 for e in prof.profiler.kineto_results.events()
             if "CUDA" in str(e.device_type())
             and "squeeze_dp_kernel" in e.name())
    return {"squeeze_spans": names(sp).count("encode.squeeze"),
            "kernels": n, "dp_kernels": dp, "device_lead_ns": lead,
            "n_outside": len(outside), "outside": outside[:5],
            "n_beyond_lead": len(beyond)}


@pytest.mark.cuda
def test_squeeze_kernels_lie_inside_their_spans_on_the_card():
    """On the card: every kernel the encode.squeeze spans launched runs
    after its span's start and before the end of the fetch that waits for
    its batch, on the trace's clock, up to the trace's own device lead
    (its device timeline against its host events, a few µs: a kernel that
    starts at once can read that much before its own launch call).  In a
    process of its own, as the benchmark's traced run is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    here = pathlib.Path(__file__).resolve().parent
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(here)!r}, {str(here.parent)!r}]\n"
            "from _torch_corpora import corpus\n"
            "from test_torch_spans import card_clock_check\n"
            "print(json.dumps(card_clock_check(corpus('text', 1 << 21, "
            "seed=44), shard_len=65536, ctx=32768, batch=8)))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    # a batch's span launches the greedy lengths' ops, the one DP kernel,
    # the walk and the masks
    assert r["squeeze_spans"] == 4 and r["dp_kernels"] == 4, r
    assert r["kernels"] > 4 * 3, r
    assert r["device_lead_ns"] < 50_000, r
    assert r["n_beyond_lead"] == 0, r
