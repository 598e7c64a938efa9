"""Bitonic compare-exchange network over a key and carried operands (B10).

Counterpart of tools/bitonic_probe.py (`run` :74, kernel `_kernel` :46),
the probe of a row-resident sort of the level-6 matcher payload: one
2^18-element row per b, held as (B, 2048, 128) u32, a key and NOPS-1
operands, and a static list of substages (j, k).  In each substage every
element i decides on its own and takes its partner i^j's key and operands
where

    (key[i^j] < key[i]) == ((i & j) == 0) == ((i & k) == 0)

with the keys compared as u32.  Equal keys make one element of a pair copy
the other's operands while the other keeps its own: operands are
duplicated, not swapped, and both versions here keep that rule.

`run` launches the CUDA kernel (csrc/sort_kernels.cu, `flate_bitonic`) on
CUDA tensors and runs `_run_plain` on CPU tensors.  The kernel takes the
substages in the passes over device memory that `plan_passes` cuts them
into.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

R, C = 2048, 128                 # one row: 262,144 elements as (R, C)
_SIGN = -(1 << 31)               # flips an int32 bit pattern to u32 order
TILE = 1 << 14                   # elements a tile pass of the kernel holds
RUN_MAX = 128                    # substages of one tile pass
DEV_MAX = 4                      # substages of one device-memory pass
# the probe's representative substage mix (bitonic_probe.calibrate): row
# swaps, mid and lane swaps, all of the last merge (k = 2^18)
CALIBRATE_MIX = ((131072, 262144), (1024, 262144), (64, 262144),
                 (8, 262144), (1, 262144), (2048, 262144), (256, 262144),
                 (16, 262144))


def bitonic_stages(n: int) -> tuple:
    """The full bitonic network on n = 2^m elements as (j, k) substages,
    the list bitonic_probe.correctness() builds (171 for n = 2^18)."""
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            stages.append((j, k))
            j //= 2
        k *= 2
    return tuple(stages)


def plan_passes(stages, n: int, tile: int = TILE) -> tuple:
    """Cut a substage list into the kernel's passes over device memory, in
    order: ("tile", run) for a run of up to RUN_MAX substages with j < tile
    (one block holds each aligned tile of `tile` elements, or several whole
    rows of n < tile), ("device", run) for a run of up to DEV_MAX substages
    with j >= tile (a thread holds the elements its j bits connect).  n is
    the row length; every j must be a power of two below it."""
    groups = []
    for j, k in stages:
        if j < 1 or j >= n or j & (j - 1):
            raise ValueError(f"bitonic: substage j={j} is not a power of "
                             f"two below {n}")
        kind, cap = ("tile", RUN_MAX) if j < tile else ("device", DEV_MAX)
        if groups and groups[-1][0] == kind and len(groups[-1][1]) < cap:
            groups[-1][1].append((j, k))
        else:
            groups.append((kind, [(j, k)]))
    return tuple((kind, tuple(run)) for kind, run in groups)


def _check(key: torch.Tensor, ops, stages) -> tuple:
    if key.dim() != 3 or key.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"bitonic: key must be (B, R, C) uint32 or int32, "
                        f"got {tuple(key.shape)} {key.dtype}")
    n = key.shape[1] * key.shape[2]
    if n & (n - 1):
        raise ValueError(f"bitonic: a row of {n} elements is not a power "
                         f"of two")
    for o in ops:
        if o.shape != key.shape or o.dtype != key.dtype \
                or o.device != key.device:
            raise ValueError("bitonic: every operand must match the key's "
                             "shape, dtype and device")
    stages = tuple((int(j), int(k)) for j, k in stages)
    return stages, plan_passes(stages, n)    # raises on a bad substage


def _partner(x: torch.Tensor, j: int) -> torch.Tensor:
    """x (B, n) -> x at i ^ j for every i (j a power of two)."""
    B, n = x.shape
    return x.reshape(B, n // (2 * j), 2, j).flip(2).reshape(B, n)


def _run_plain(key: torch.Tensor, ops, stages) -> tuple:
    """The probe's rule substage by substage, on the key and on every
    operand: returns (key, *ops) with the inputs' shape and dtype."""
    stages, _ = _check(key, ops, stages)
    shape, dtype = key.shape, key.dtype
    B = shape[0]
    n = shape[1] * shape[2]
    # int32 bit patterns; the key XOR the sign bit orders as u32
    k = key.reshape(B, n).view(torch.int32) ^ _SIGN
    vals = [o.reshape(B, n).view(torch.int32) for o in ops]
    i = torch.arange(n, dtype=torch.int32, device=key.device)
    for j, kk in stages:
        kp = _partner(k, j)
        up = (i & j) == 0
        asc = (i & kk) == 0
        takep = (kp < k) == (up == asc)
        k = torch.where(takep, kp, k)
        vals = [torch.where(takep, _partner(v, j), v) for v in vals]
    k = k ^ _SIGN
    return tuple(v.contiguous().view(dtype).reshape(shape)
                 for v in [k, *vals])


def run(key: torch.Tensor, ops, stages) -> tuple:
    """key and each operand (B, R, C) uint32 (or int32 bit patterns);
    stages a sequence of (j, k).  Returns the tuple (key, *ops) after the
    substages, as the probe's `run` does."""
    ops = list(ops)
    stages, plan = _check(key, ops, stages)
    if _build.use_plain(key):
        return _run_plain(key, ops, stages)
    B = key.shape[0]
    n = key.shape[1] * key.shape[2]
    for name, t in [("key", key)] + [(f"op{i}", o) for i, o in
                                     enumerate(ops)]:
        _build.check_cuda(f"bitonic.{name}", t, key.dtype, tuple(key.shape))
    key_out = torch.empty_like(key)
    ops_out = [torch.empty_like(o) for o in ops]
    pairs = torch.empty((B, n), dtype=torch.int64, device=key.device)
    # the operands' records for the gather: up to 8 u32 an element
    rec = torch.empty((B, n, 8) if ops else (1, 8), dtype=torch.int32,
                      device=key.device)
    # host arrays the entry point reads before it returns
    ins = (ctypes.c_void_p * max(1, len(ops)))(*[o.data_ptr() for o in ops])
    outs = (ctypes.c_void_p * max(1, len(ops)))(
        *[o.data_ptr() for o in ops_out])
    st = np.ascontiguousarray(np.asarray(stages, dtype=np.int32).reshape(-1))
    groups, at = [], 0
    for kind, group in plan:
        groups += [0 if kind == "tile" else 1, at, len(group)]
        at += len(group)
    gp = np.ascontiguousarray(np.asarray(groups, dtype=np.int32))
    _build.launch("flate_bitonic", key.data_ptr(), ctypes.addressof(ins),
                  ctypes.addressof(outs), len(ops), key_out.data_ptr(),
                  pairs.data_ptr(), rec.data_ptr(), B, n, st.ctypes.data,
                  len(stages), gp.ctypes.data, len(plan))
    return (key_out, *ops_out)
