"""The two sides of chip_smoke.py ROUTE_PINNED: each case's member from the
JAX package (the call the pin was computed with, Pallas kernels in
interpret mode) and from the port on a device.

Cases (chip_smoke.py ROUTE_INPUTS names their inputs):
  stream32M-l6, stream32M-l6-flushed: phase 10's gzip.compressor at level
      6 on 32 MiB mixed in writes of 3 MiB + 17 B with a flush at 11 MiB:
      the member, and what the writer held after the flush;
  fdict-l6, nodict-l6: phase 10's zlib.compress(text x 4) with and without
      dictionary=32 KiB of text, level 6;
  round1-l{1,6,9}, round1s-l{1,6,9}: phase 15's round-1 compress_device
      (jx/pipeline) at its defaults on 8 MiB + 12,345 B of mixed and on its
      first 2 shards + 12,345 B;
  pigz-l6: phase 15's 2 MiB + 12,345 B at level 6, compress_device(batch=1),
      which pigz.compress_mesh must equal;
  mixed32M-l{1,3}: phase 4's api.gzip.compress of 32 MiB mixed;
  text-l{1,3,6,9}: phases 4 and 8's api.gzip.compress of bench.py's text
      corpus (3,359,630 B, 26 shards in one batch).
All at the headline's shard shape, 128 KiB shards with 32 KiB of context
(the round-1 cases at batch 8, their default).  Besides them, a case of
the tests alone: zlib.compressor with a 32 KiB dictionary and a flush
(dict_stream_input)."""

from __future__ import annotations

import functools
import io

from chip_smoke import (B, CTX, ROUTE_PINNED, S, mixed_corpus, route_input,
                        stream_writes, text_corpus)

from flate_tpu_torch.containers import Container

# the tests' streaming case: zlib.compressor with a 32 KiB text dictionary
# at the headline's shard shape in batches of 2, on 2 shards + 40,000 B of
# mixed written in pieces cut at DICT_CUTS, flushed after the second write
DICT_CUTS = (70_001, 150_017, 230_000)
DICT_BATCH = 2


def dict_stream_input() -> tuple:
    return mixed_corpus(2 * S + 40_000), text_corpus(32 * 1024)


def _dict_writes(c, sink, data: bytes) -> tuple:
    """Writes cut at DICT_CUTS, a flush after the second; returns (member,
    the writer's bytes after the flush)."""
    edges = (0, *DICT_CUTS, len(data))
    flushed = None
    for i in range(len(edges) - 1):
        c.write(data[edges[i]:edges[i + 1]])
        if i == 1:
            c.flush()
            flushed = sink.getvalue()
    c.finish()
    return sink.getvalue(), flushed


def _case(case: str) -> tuple:
    """(name, level, input bytes) of a ROUTE_PINNED case."""
    name, level = case.split("-")[0], int(case.split("-l")[1][0])
    return name, level, route_input(ROUTE_PINNED[case][0])


# ---- the JAX package ------------------------------------------------------

def _j_opts(level: int, batch: int = B):
    from flate_tpu.deflate import CompressOptions
    return CompressOptions(level=level, shard_len=S, ctx=CTX, batch=batch,
                           interpret=True)


@functools.lru_cache(maxsize=None)
def jax_stream(level: int) -> tuple:
    import flate_tpu as ft
    sink = io.BytesIO()
    c = ft.gzip.compressor(sink, level=level, opts=_j_opts(level),
                           device=True)
    return stream_writes(c, sink, route_input("mixed32M"))


@functools.lru_cache(maxsize=None)
def jax_dict_stream(level: int) -> tuple:
    import flate_tpu as ft
    data, zd = dict_stream_input()
    sink = io.BytesIO()
    c = ft.zlib.compressor(sink, level=level, opts=_j_opts(level, DICT_BATCH),
                           dictionary=zd, device=True)
    return _dict_writes(c, sink, data)


def jax_route(case: str) -> bytes:
    """The JAX package's bytes of a ROUTE_PINNED case (11 s to 31 minutes
    on the CPU)."""
    import flate_tpu as ft
    from flate_tpu.containers import Container as JContainer
    from flate_tpu.jx import pipeline as j_pl
    from flate_tpu.jx import pipeline2 as j_pipeline2

    name, level, data = _case(case)
    if name == "stream32M":
        member, flushed = jax_stream(level)
        return flushed if case.endswith("-flushed") else member
    if name in ("fdict", "nodict"):
        zd = text_corpus(32 * 1024) if name == "fdict" else None
        return ft.zlib.compress(data, level=level, opts=_j_opts(level),
                                dictionary=zd, device=True)
    if name in ("round1", "round1s", "pigz"):
        kw = {"batch": 1} if name == "pigz" else {}
        return j_pl.compress_device(data, level, JContainer.GZIP, **kw)
    return j_pipeline2.compress_device2(
        data, level=level, container=JContainer.GZIP, shard_len=S, ctx=CTX,
        batch=B, interpret=True)


# ---- the port ------------------------------------------------------------

def port_dict_stream(level: int, device) -> tuple:
    from flate_tpu_torch import api
    data, zd = dict_stream_input()
    sink = io.BytesIO()
    c = api.zlib.compressor(sink, level=level, dictionary=zd,
                            batch=DICT_BATCH, device=device)
    return _dict_writes(c, sink, data)


def port_route(case: str, device="cpu", **kw) -> bytes:
    """The port's bytes of a ROUTE_PINNED case through the entry point
    chip_smoke.py drives on the card (kw: other knobs of that call)."""
    from flate_tpu_torch import api
    from flate_tpu_torch.device import pipeline as r1

    name, level, data = _case(case)
    if name == "stream32M":
        sink = io.BytesIO()
        member, flushed = stream_writes(
            api.gzip.compressor(sink, level=level, device=device), sink, data)
        return flushed if case.endswith("-flushed") else member
    if name in ("fdict", "nodict"):
        zd = text_corpus(32 * 1024) if name == "fdict" else None
        return api.zlib.compress(data, level, dictionary=zd, device=device,
                                 **kw)
    if name in ("round1", "round1s", "pigz"):
        kw = {"batch": 1} if name == "pigz" else kw
        return r1.compress_device(data, level, Container.GZIP,
                                  device=device, **kw)
    return api.gzip.compress(data, level, device=device, **kw)
