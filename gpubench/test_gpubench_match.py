"""The match stage's three readers on a synthetic trace and spans:
match_idle_pct.encode (idle device ns under encode.match and its passes),
k3_launches_per_batch.encode (launches inside encode.match.k3 per batch)
and match_busy_pct.encode (the match kernels' share of the busy time);
each None without a trace, and the span readers None without spans; then
the level-9 cell, traced on the CPU at a small size, reports them."""

import time
from types import SimpleNamespace

import pytest
import torch

from gpubench import harness, registry, spans, tracing

READERS = ("match_idle_pct.encode", "k3_launches_per_batch.encode",
           "match_busy_pct.encode")


def span(name, start, end, id, parent=None):
    return {"name": name, "start_ns": start, "end_ns": end, "id": id,
            "parent": parent, "call": 1, "attrs": {}}


def trace():
    """Window [0, 1000); device busy [100, 300) (prep 100-150, sort
    150-200, matcher 200-300), [320, 340) (extend) and [600, 700) (pack);
    launches at 110, 130, 160, 330, 650 and one at 990 outside every
    span."""
    t = tracing.Trace()
    t.spans = [(0, 1000, "gpubench.compress")]
    t.device = [(100, 150, "void prep_kernel<3>(int const*)"),
                (150, 200, "void at::native::radixSortKVInPlace<int>()"),
                (200, 300, "void matcher_kernel<1, false>(int*)"),
                (320, 340, "extend_kernel(int const*, int*)"),
                (600, 700, "pack_kernel(unsigned int*)")]
    t.host = [(110, 112, "cudaLaunchKernel"), (130, 132, "cuLaunchKernel"),
              (160, 165, "cudaLaunchKernel"), (170, 175, "aten::sort"),
              (330, 332, "cudaLaunchKernel"), (650, 655, "cudaLaunchKernel"),
              (990, 995, "cudaLaunchKernel")]
    return t


# zlib.compress [10, 950) > encode.dispatch [20, 800) > encode.match
# [30, 400) > .main [40, 100), .k3 [100, 200), .extend [200, 380);
# encode.fields [400, 800)
SPANS = [span("zlib.compress", 10, 950, 1),
         span("encode.dispatch", 20, 800, 2, 1),
         span("encode.match", 30, 400, 3, 2),
         span("encode.match.main", 40, 100, 4, 3),
         span("encode.match.k3", 100, 200, 5, 3),
         span("encode.match.extend", 200, 380, 6, 3),
         span("encode.fields", 400, 800, 7, 2)]


def run(op="compress", with_trace=True):
    return SimpleNamespace(trace=trace() if with_trace else None,
                           mix={"op": op})


def read(name, r):
    return registry.reader("layer_metrics", name)(r)


def test_values_are_known(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: SPANS)
    r = run()
    # idle [0, 100), [300, 320), [340, 600), [700, 1000): under the match
    # spans 30-40 (match), 40-100 (main), 300-320 and 340-380 (extend),
    # 380-400 (match): 150 ns of the 1000 ns window
    assert read("match_idle_pct.encode", r) == pytest.approx(15.0)
    # launches at 110, 130, 160 inside k3; one batch
    assert read("k3_launches_per_batch.encode", r) == 3
    # prep 50 + matcher 100 + extend 20 of 320 busy; the sort and the
    # pack are left out
    assert read("match_busy_pct.encode", r) == pytest.approx(100 * 170 / 320)


def test_none_without_trace_spans_or_encode(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: SPANS)
    for name in READERS:
        assert read(name, run(with_trace=False)) is None
        assert read(name, run("decompress")) is None
    # a program that records no spans: the span readers give None, the
    # trace's reader still reads
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    assert read("match_idle_pct.encode", run()) is None
    assert read("k3_launches_per_batch.encode", run()) is None
    assert read("match_busy_pct.encode", run()) == pytest.approx(
        100 * 170 / 320)


def test_k3_none_where_the_program_has_no_pass_spans(monkeypatch):
    """A program whose encode.match holds no pass spans (the parent of
    these spans): k3 launches are not read as 0."""
    monkeypatch.setattr(spans, "program_spans", lambda: [
        s for s in SPANS if not s["name"].startswith("encode.match.")])
    r = run()
    assert read("k3_launches_per_batch.encode", r) is None
    # its idle share reads encode.match alone: 30-100, 300-320, 340-400
    assert read("match_idle_pct.encode", r) == pytest.approx(15.0)


def test_no_busy_time_reads_none():
    r = run()
    r.trace.device = []
    assert read("match_busy_pct.encode", r) is None


def test_level9_cell_reports_them():
    """zlib9-encode-32M traced on the CPU at a small size: the span readers
    report (no launch on the CPU), the trace's reader has no kernel."""
    from gpubench.test_gpubench_faults import SMALL_CONFIG
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run_cell(registry.benchmark(), "zlib9-encode-32M",
                             2**31 + 11, 0.3, True, "cpu",
                             time.perf_counter(),
                             overrides={"config": SMALL_CONFIG})
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert 0 < m["match_idle_pct.encode"]["value"] < 100
    assert m["k3_launches_per_batch.encode"]["value"] == 0
    assert "match_busy_pct.encode" not in m
