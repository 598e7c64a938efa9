"""Seeded streams and JAX-side reference arguments shared by the decode
parity tests of the PyTorch port (tests/test_torch_inflate2.py,
tests/test_torch_anyinflate.py).

Small shapes as in tests/test_jx_inflate2.py: shards of 7168 bytes, 1024
bytes of context, batches of 3.  Streams of the JAX encoder run its Pallas
kernels in interpret mode and are made once per test process (lru_cache).
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

from flate_tpu.containers import Container as JContainer
from flate_tpu.containers import parse_header as j_parse_header
from flate_tpu.jx import inflate2 as j_inflate2
from flate_tpu.jx import pipeline2 as j_pipeline2

from flate_tpu_torch.device import pipeline2

from _torch_corpora import rfc_text

S = 7168
CTX = 1024
BATCH = 3


def text(n: int) -> bytes:
    t = rfc_text()
    return (t * (n // len(t) + 1))[:n]


@functools.lru_cache(maxsize=None)
def inputs(name: str) -> bytes:
    """The named whole-slice inputs."""
    if name == "text":
        return text(3 * S + 500)
    if name == "random":                 # stored shards
        rng = np.random.default_rng(3)
        return bytes(rng.integers(0, 256, 2 * S + 77, dtype=np.uint8))
    if name == "period":                 # cross-shard matches
        rng = np.random.default_rng(7)
        period = bytes(rng.integers(0, 256, CTX, dtype=np.uint8))
        return period * (2 * S // CTX)
    if name == "segmented":              # stored and coded blocks in a shard
        rng = np.random.default_rng(9)
        t = np.frombuffer(text(2048), np.uint8)
        parts = []
        for _ in range(4):
            parts += [t, rng.integers(0, 256, 3 * 1024, dtype=np.uint8), t]
        return np.concatenate(parts).tobytes()
    if name == "empty":
        return b""
    if name == "one":
        return b"x"
    raise ValueError(name)


@functools.lru_cache(maxsize=None)
def jax_blob(name: str, level: int) -> bytes:
    """`name` as one gzip member of the JAX device encoder."""
    return j_pipeline2.compress_device2(
        inputs(name), level=level, shard_len=S, ctx=CTX, batch=BATCH,
        interpret=True)


@functools.lru_cache(maxsize=None)
def port_blob(name: str, level: int) -> bytes:
    """`name` as one gzip member of the port's own encoder, on the CPU."""
    return pipeline2.compress_device2(
        inputs(name), level=level, shard_len=S, ctx=CTX, batch=BATCH,
        device="cpu")


def gz(data: bytes, level: int, strategy: int = zlib.Z_DEFAULT_STRATEGY
       ) -> bytes:
    """One unindexed gzip member made by CPython's zlib."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"
            + c.compress(data) + c.flush()
            + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF))


def shards_of(blob: bytes):
    """[(shard bytes, out_len)] of an indexed member, by the JAX package's
    header and index parsers."""
    hdr, meta = j_parse_header(JContainer.GZIP, blob)
    comp_lens, out_lens, _ = j_inflate2.parse_index_extra(meta.extra)
    starts = hdr + np.concatenate([[0], np.cumsum(comp_lens)[:-1]])
    return [(blob[int(s):int(s) + int(c)], int(o))
            for s, c, o in zip(starts, comp_lens, out_lens)]


def coded_run(blob: bytes, hist: bytes = b""):
    """The JAX package's pack_coded_run tuple, as numpy arrays, for the
    leading coded shards of an indexed member."""
    run = []
    for sh, out_len in shards_of(blob):
        p = j_inflate2.plan_shard(sh, out_len)
        if p.kind != "coded":
            break
        run.append((p, sh))
    return tuple(np.asarray(a) for a in j_inflate2.pack_coded_run(run, hist))
