"""The program-span readers on a synthetic trace and spans: idle device ns
summed exactly by the innermost span open, launches counted inside spans,
the six metrics, and None without a trace or without spans; then each
cell, traced on the CPU at a small size, reports its new metrics."""

import time
from types import SimpleNamespace

import pytest
import torch

from gpubench import harness, registry, spans, tracing

NEW = {"pigz6-encode-32M": ["squeeze_idle_pct.encode",
                            "fields_idle_pct.encode",
                            "squeeze_launches_per_batch.encode"],
       "pigz6-decode-text-32M": ["plan_idle_pct.decode",
                                 "serial_retry_pct.decode"],
       "zlib6-decode-32M": ["chain_plan_idle_pct.decode"],
       "zlib6-stream-decode-32M": ["chain_plan_idle_pct.decode"]}


def span(name, start, end, id, parent=None):
    return {"name": name, "start_ns": start, "end_ns": end, "id": id,
            "parent": parent, "call": 1, "attrs": {}}


def trace():
    """Window [0, 1000); device busy [100, 300) and [600, 700); launches
    at 150, 450, 460, 650 and one at 990 outside every span."""
    t = tracing.Trace()
    t.spans = [(0, 1000, "gpubench.compress")]
    t.device = [(100, 300, "k1"), (600, 700, "k2")]
    t.host = [(150, 155, "cudaLaunchKernel"), (450, 455, "cudaLaunchKernel"),
              (460, 465, "cuLaunchKernel"), (470, 480, "aten::add"),
              (650, 655, "cudaLaunchKernel"),
              (990, 995, "cudaLaunchKernel")]
    return t


# gzip.compress [10, 950) > encode.dispatch [20, 800) > encode.squeeze
# [50, 500) > encode.squeeze.dp [400, 470); encode.fields [500, 800)
SPANS = [span("gzip.compress", 10, 950, 1),
         span("encode.dispatch", 20, 800, 2, 1),
         span("encode.squeeze", 50, 500, 3, 2),
         span("encode.squeeze.dp", 400, 470, 4, 3),
         span("encode.fields", 500, 800, 5, 2),
         span("decode.batch", 2000, 3000, 6)]      # outside the window


def run(op="compress", with_trace=True):
    return SimpleNamespace(trace=trace() if with_trace else None,
                           mix={"op": op})


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: SPANS)


def test_segments_are_the_innermost_span():
    assert spans.segments(SPANS, 0, 1000) == [
        (0, 10, spans.NO_SPAN), (10, 20, "gzip.compress"),
        (20, 50, "encode.dispatch"), (50, 400, "encode.squeeze"),
        (400, 470, "encode.squeeze.dp"), (470, 500, "encode.squeeze"),
        (500, 800, "encode.fields"), (800, 950, "gzip.compress"),
        (950, 1000, spans.NO_SPAN)]


def test_idle_ns_and_launches_by_span(synthetic, capsys):
    r = run()
    t = spans.read(r)
    # idle: [0, 100), [300, 600), [700, 1000)
    assert t.idle_ns == {spans.NO_SPAN: 10 + 50, "gzip.compress": 10 + 150,
                         "encode.dispatch": 30,
                         "encode.squeeze": 50 + 100 + 30,
                         "encode.squeeze.dp": 70, "encode.fields": 100 + 100}
    assert sum(t.idle_ns.values()) == 1000 - tracing.busy_ns(r.trace)
    assert t.launches == {"encode.squeeze": 1, "encode.squeeze.dp": 2,
                          "encode.fields": 1, spans.NO_SPAN: 1}
    assert t.count == {"gzip.compress": 1, "encode.dispatch": 1,
                       "encode.squeeze": 1, "encode.squeeze.dp": 1,
                       "encode.fields": 1}
    err = capsys.readouterr().err
    assert "in stage spans" in err and "encode.squeeze: idle" in err
    # built and logged once a run
    assert spans.read(r) is t and capsys.readouterr().err == ""


def test_the_six_readers(synthetic):
    read = lambda name, r: registry.reader("layer_metrics", name)(r)  # noqa
    enc = run()
    assert read("squeeze_idle_pct.encode", enc) == pytest.approx(25.0)
    assert read("fields_idle_pct.encode", enc) == pytest.approx(20.0)
    assert read("squeeze_launches_per_batch.encode", enc) == 3
    for name in ("plan_idle_pct.decode", "chain_plan_idle_pct.decode",
                 "serial_retry_pct.decode"):
        assert read(name, enc) is None
    dec = run("decompress")
    assert read("plan_idle_pct.decode", dec) == 0.0
    assert read("serial_retry_pct.decode", dec) is None    # no batch
    assert read("squeeze_idle_pct.encode", dec) is None


def test_decode_readers(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: [
        span("gzip.decompress", 0, 1000, 1),
        span("decode.index", 0, 50, 2, 1),
        span("decode.plan", 300, 400, 3, 1),
        span("decode.batch", 400, 500, 4, 1),
        span("decode.upload", 500, 520, 5, 1),
        span("decode.batch", 520, 540, 6, 1),
        span("decode.retry", 540, 560, 7, 1),
        span("chain.plan", 700, 800, 8, 1),
        span("chain.link", 800, 900, 9, 1)])
    r = run("decompressor")
    read = lambda name: registry.reader("layer_metrics", name)(r)  # noqa
    # idle [0, 100), [300, 600), [700, 1000)
    assert read("plan_idle_pct.decode") == pytest.approx(
        100 * (50 + 100 + 20) / 1000)
    assert read("chain_plan_idle_pct.decode") == pytest.approx(20.0)
    assert read("serial_retry_pct.decode") == pytest.approx(50.0)


def test_none_without_trace_or_spans(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: SPANS)
    assert spans.read(run(with_trace=False)) is None
    for name in NEW["pigz6-encode-32M"]:
        assert registry.reader("layer_metrics", name)(
            run(with_trace=False)) is None
    # a program that records no spans (or none in the window)
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    for name in NEW["pigz6-encode-32M"]:
        assert registry.reader("layer_metrics", name)(run()) is None
    monkeypatch.setattr(spans, "program_spans", lambda: SPANS[-1:])
    assert spans.read(run()) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent of the spans: flate_tpu_torch.metrics has no spans()."""
    from flate_tpu_torch import metrics
    monkeypatch.delattr(metrics, "spans")
    assert spans.program_spans() == []
    assert registry.reader("layer_metrics", "fields_idle_pct.encode")(
        run()) is None


@pytest.mark.parametrize("cell", sorted(NEW))
def test_each_cell_reports_its_span_metrics(cell, monkeypatch):
    """Each cell traced on the CPU at a small size: its new metrics are in
    the result and read what they should."""
    from gpubench.test_gpubench_faults import SMALL_CONFIG, TRIM, WINDOW
    from flate_tpu_torch import api
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    bench = registry.benchmark()
    mix = {}
    if cell == "zlib6-stream-decode-32M":
        monkeypatch.setattr(api.Decompressor, "WINDOW", WINDOW)
        monkeypatch.setattr(api.Decompressor, "TRIM", TRIM)
        mix["read_bytes"] = 4099
    try:
        r = harness.run_cell(bench, cell, 2**31 + 7, 0.3, True, "cpu",
                             time.perf_counter(),
                             overrides={"config": SMALL_CONFIG, "mix": mix})
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    for name in NEW[cell]:
        assert name in m, name
    for name in ("squeeze_idle_pct.encode", "fields_idle_pct.encode",
                 "plan_idle_pct.decode", "chain_plan_idle_pct.decode"):
        if name in m:
            assert 0 < m[name]["value"] < 100, name
    if cell == "pigz6-encode-32M":
        # the CPU makes no launch calls
        assert m["squeeze_launches_per_batch.encode"]["value"] == 0
    if cell == "pigz6-decode-text-32M":
        assert m["serial_retry_pct.decode"]["value"] >= 0
