"""One CUDA graph a batch: captured once per key, replayed for every batch.

The JAX package runs a batch as one XLA program (`jax.jit` of
`pipeline2.encode_batch`, compiled once per shape and static knobs).  Its
counterpart here is one CUDA graph per key, captured on first use and
replayed for every batch, so a batch costs one graph launch of host time
instead of thousands of kernel launches.

`Graph(fn, inputs)` runs fn once on a side stream (the warm-up that
torch.cuda.graphs asks for: the kernels' build, lazy loads and the
modules' per-device constants happen there, outside the capture), then
captures fn over static copies of the inputs into the memory pool that
the live graphs of the device share.  Graphs of different keys never run
at once and every replay is followed by a copy of its outputs, so
sharing the pool is safe.  A call
copies the inputs into the static ones, replays, adds the kernel launches
the capture recorded to `_build.LAUNCHES` (the capture itself launches
nothing, so it adds none), and returns copies of the outputs: the next
replay overwrites the static ones while the caller may still hold a batch
in flight.  A failed capture or replay raises; nothing runs eagerly in its
place.
"""

from __future__ import annotations

import collections
import ctypes
import time

import torch

from .. import _build

MAX_GRAPHS = 8                  # graphs kept alive (least recently used go)


def _node_count(raw_graph: int) -> int:
    """Nodes of a captured cudaGraph_t (libcuda's cuGraphGetNodes)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    rc = libcuda.cuGraphGetNodes(ctypes.c_void_p(raw_graph), None,
                                 ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes returned CUresult {rc}")
    return count.value


class Graph:
    """fn(*inputs) -> tuple of tensors, captured in one CUDA graph.

    inputs are CUDA tensors whose shapes and dtypes every call repeats;
    pool is another graph's `graph.pool()` to share, or None for a pool of
    its own.  Attributes: capture_s and instantiate_s (host seconds),
    nodes, replays, and launches (kernel launches a replay runs, by
    name)."""

    def __init__(self, fn, inputs, pool=None):
        dev = inputs[0].device
        with torch.cuda.device(dev):
            self._capture(fn, inputs, dev, pool)
        self.replays = 0

    def _capture(self, fn, inputs, dev, pool) -> None:
        self.inputs = [x.clone() for x in inputs]
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(*self.inputs)
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        saved = collections.Counter(_build.LAUNCHES)
        # kept after capture, so that its nodes can be counted and its
        # instantiation timed apart
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = tuple(fn(*self.inputs))
        self.capture_s = time.perf_counter() - t
        self.launches = _build.LAUNCHES - saved
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)
        self.nodes = _node_count(self.graph.raw_cuda_graph())
        t = time.perf_counter()
        self.graph.instantiate()
        self.instantiate_s = time.perf_counter() - t

    def __call__(self, *inputs) -> tuple[torch.Tensor, ...]:
        for static, x in zip(self.inputs, inputs, strict=True):
            static.copy_(x)
        with torch.cuda.device(self.inputs[0].device):
            self.graph.replay()
        self.replays += 1
        _build.LAUNCHES.update(self.launches)
        return tuple(o.clone() for o in self.outputs)


_GRAPHS: collections.OrderedDict = collections.OrderedDict()


def cached(key: tuple, fn, inputs) -> Graph:
    """The graph of `key` (which must name fn, the device and every shape
    and static knob fn depends on), captured from fn on first use."""
    g = _GRAPHS.get(key)
    if g is None:
        dev = inputs[0].device
        # the pool of a live graph on this device; a pool whose graphs
        # are all gone is gone too, so a new one when there is none
        pool = next((h.graph.pool() for h in _GRAPHS.values()
                     if h.inputs[0].device == dev), None)
        g = Graph(fn, inputs, pool)
        _GRAPHS[key] = g
        while len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    return g


def clear() -> None:
    """Drop every cached graph."""
    _GRAPHS.clear()
