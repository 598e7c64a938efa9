"""The bound arithmetic is chip_smoke.py's, and the trace readers count a
synthetic trace as they should: busy time as the union of device
intervals, idle gaps by the host operation open, launches and roofline
share by kernel name."""

from types import SimpleNamespace

import pytest

from gpubench import bounds, registry, tracing


def test_bounds_are_chip_smoke_numbers():
    """chip_smoke.py phases 3 and 7 at level 6 (B = 64, S = 128 KiB,
    ctx = 32 KiB) printed these bounds, in ms, and the matcher's bytes."""
    b = bounds.launch_bytes(64, 131072, 32768, 6)
    assert b["matcher_kernel"] == 94372352
    ms = {k: round(v / bounds.HBM_BYTES_PER_S * 1e3, 4) for k, v in b.items()}
    assert ms == {"prep_kernel": 0.0157, "matcher_kernel": 0.0282,
                  "small_runs_kernel": 0.0282, "extend_kernel": 0.0376,
                  "parse_rows_kernel": 0.0125, "parse_ring_kernel": 0.0125,
                  "pack_kernel": 0.0459}


def trace():
    t = tracing.Trace()
    t.spans = [(0, 1000, "gpubench.compress")]
    t.device = [(100, 300, "void prep_kernel(unsigned char const*)"),
                (200, 400, "void matcher_kernel<8, false>(int const*)"),
                (600, 700, "void extend2_kernel(int const*)"),
                (650, 800, "Memcpy DtoH (Device -> Pinned)")]
    t.host = [(0, 50, "aten::empty"), (420, 560, "aten::nonzero"),
              (430, 440, "cudaStreamSynchronize")]
    t.launches = 3
    return t


def test_busy_is_the_union_of_device_intervals():
    t = trace()
    assert tracing.busy_intervals(t) == [[100, 400], [600, 800]]
    assert tracing.busy_ns(t) == 500


def test_idle_gaps_by_the_host_operation_open():
    idle = tracing.idle_by_host(trace())
    # [0, 100): aten::empty ended at 50, the call's span is open at 50;
    # [400, 600): aten::nonzero open at 500; [800, 1000) nothing open
    assert idle == {"host code between operations in gpubench.compress":
                    300, "aten::nonzero": 200}


def run(op="compress", nbytes=2 << 20):
    cfg = {"encode_batch": 64, "shard_len": 131072, "ctx": 32768,
           "level": 6}
    call = SimpleNamespace(error=None, n_in=nbytes, n_out=nbytes)
    return SimpleNamespace(trace=trace(), mix={"op": op}, cfg=cfg,
                           done=[call], calls=[call], bytes_in=nbytes,
                           bytes_out=nbytes, counters={}, window_s=1.0)


def test_layer_readers_on_a_synthetic_trace():
    r = run()
    read = lambda name: registry.reader("layer_metrics", name)(r)  # noqa
    assert read("device_idle_pct.encode") == pytest.approx(50.0)
    assert read("device_idle_pct.decode") is None
    assert read("launch_calls_per_mib.encode") == pytest.approx(1.5)
    # prep and matcher: their bytes bound over 400 ns of their time;
    # extend2_kernel is none of the six
    b = bounds.launch_bytes(64, 131072, 32768, 6)
    want = 100 * (b["prep_kernel"] + b["matcher_kernel"]) \
        / bounds.HBM_BYTES_PER_S / 400e-9
    assert read("encode_kernels_roofline") == pytest.approx(want)
    assert read("chained_rounds.decode") is None
    d = run("decompress")
    d.counters = {"inflate2.chained_rounds": 33}
    assert registry.reader("layer_metrics", "chained_rounds.decode")(d) == 33
