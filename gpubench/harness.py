"""One run of a cell: set-up, the measured window, the check, the result.

run_cell makes the cell's pool of inputs from the seed, prepares the op
(the streams a decode reads are made here), warms every input once, then
calls the program in a closed loop, one caller, pool input after pool
input, until `seconds` have passed and every input has been called: the
window closes when the call that passes them returns, so every call
counted is whole.  Traced, the window
is the mix's `trace_calls` calls under torch.profiler instead.  Once the
window has closed it reads the device's peak memory, makes the op's calls
after the window, frees the program's state and checks every answer with
the plain reference."""

from __future__ import annotations

import gc
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import registry, tracing

POOL_STRIDE = 1 << 40    # pool input k of a run is made from seed + k * this


@dataclass
class Call:
    k: int                         # pool input
    t0: float
    t1: float
    answer: object = None
    error: str | None = None
    n_in: int = 0                  # bytes the call read
    n_out: int = 0                 # bytes it returned


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: dict
    cfg: dict
    mix: dict
    calls: list
    window_s: float
    setup_s: float
    trace: tracing.Trace | None = None
    counters: dict = field(default_factory=dict)

    @property
    def done(self) -> list:
        return [c for c in self.calls if c.error is None]

    @property
    def bytes_in(self) -> int:
        return sum(c.n_in for c in self.done)

    @property
    def bytes_out(self) -> int:
        return sum(c.n_out for c in self.done)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def counters() -> dict:
    """The program's own counters: inflate2.STATS and _build.LAUNCHES."""
    from flate_tpu_torch import _build
    from flate_tpu_torch.device import inflate2
    return {**{f"inflate2.{k}": v for k, v in inflate2.STATS.items()},
            **{f"launches.{k}": v for k, v in _build.LAUNCHES.items()}}


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _window(op, state, n_pool, seconds, max_calls, span, device) -> list:
    from torch.profiler import record_function
    calls: list = []
    start = time.perf_counter()
    while True:
        k = len(calls) % n_pool
        t0 = time.perf_counter()
        try:
            with record_function(span):
                answer = op.call(state, k)
            _sync(device)
            c = Call(k, t0, time.perf_counter(), answer)
        except Exception:       # the run goes on and counts the call failed
            c = Call(k, t0, time.perf_counter(), error=traceback.format_exc())
            log(c.error)
        calls.append(c)
        if max_calls:
            if len(calls) >= max_calls:
                return calls
        elif c.t1 - start >= seconds and len(calls) >= n_pool:
            return calls


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device: str, t_start: float, *,
             control: bool = False, overrides: dict | None = None) -> dict:
    """The result of one run of cell `cell_name`: the contract's keys, the
    checks last.  `t_start`: the perf_counter of the process's start;
    `overrides`: {"config": {...}, "mix": {...}} entries that replace the
    files' (tests run a cell at a small size with them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import flate_tpu_torch as prog

    overrides = overrides or {}
    cuda = torch.device(device).type == "cuda"
    w = registry.cell(bench, cell_name)
    cfg = {**registry.config(bench, w["config"]),
           **overrides.get("config", {})}
    mix = {**registry.mix(w["traffic"]), **overrides.get("mix", {})}
    op = registry.op(mix["op"])
    corpus = registry.corpus(mix["corpus"])
    size = mix.get("size", cfg["file_bytes"])
    inputs = [corpus.make(size, seed + k * POOL_STRIDE)
              for k in range(mix["pool"])]
    state = op.prepare(prog, cfg, mix, inputs, device, control)
    for k in range(len(inputs)):            # every input's shapes, once
        op.call(state, k)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.4f} s: {len(inputs)} inputs of {size} B")

    span = f"{tracing.SPAN_PREFIX}{mix['op']}"
    before = counters()
    trace = None
    if traced:
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            calls = _window(op, state, len(inputs), seconds,
                            mix["trace_calls"], span, device)
        trace = tracing.read(prof)
        del prof
    else:
        calls = _window(op, state, len(inputs), seconds, 0, span, device)
    window_s = calls[-1].t1 - calls[0].t0
    after_counts = counters()
    delta = {k: v - before.get(k, 0) for k, v in after_counts.items()
             if v != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for c in calls:
        if c.error is None:
            c.n_in, c.n_out = op.sizes(state, c.k, c.answer)
    after = op.after_window(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    secs = [c.t1 - c.t0 for c in calls]
    log(f"window {window_s:.4f} s, {len(calls)} calls, call s min "
        f"{min(secs):.4f} median {statistics.median(secs):.4f} max "
        f"{max(secs):.4f}; counters {delta}")
    log("call s by input: " + "; ".join(
        f"{k}: " + " ".join(f"{c.t1 - c.t0:.4f}" for c in calls if c.k == k)
        for k in range(len(inputs))))

    t_ref = time.perf_counter()
    checks = op.check(cfg, mix, inputs, calls, after, seed)
    log(f"reference {time.perf_counter() - t_ref:.4f} s")

    run = Run(w, cfg, mix, calls, window_s, setup_s, trace, delta)
    metrics = {}
    kind = "layer_metrics" if traced else "e2e_metrics"
    for m in registry.metrics(bench, cell_name, traced):
        v = registry.reader(kind, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    failed = sum(c.error is not None for c in calls)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": w["chips"], "memory_peak_bytes": peak}
    result = {"correct": failed == 0 and all(v <= lim for v, lim
                                             in checks.values()),
              "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        lo, hi = trace.window
        dev["busy_s"] = tracing.busy_ns(trace) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        copies = sum(n.startswith(("Memcpy", "Memset"))
                     for _, _, n in trace.device)
        log(f"trace: events {trace.kinds}, of which copies and sets on "
            f"the device {copies}; launch calls {trace.launch_names}")
        result["breakdown"] = {
            "device_ops": tracing.top(tracing.device_time_by_name(trace)),
            "idle_gaps": tracing.top(tracing.idle_by_host(trace))}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result
