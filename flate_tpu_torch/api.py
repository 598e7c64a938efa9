"""Public surface of the PyTorch port.

    import flate_tpu_torch as ftt
    blob = ftt.gzip.compress(data, level=6)              # on the CUDA card
    blob = ftt.zlib.compress(data, level=3, device="cpu")
    blob = ftt.zlib.compress(data, dictionary=d)         # FDICT member
    data = ftt.gzip.decompress(blob)                     # on the CUDA card
    data = ftt.gzip.decompress(blob, device="cpu", walk="serial")

    c = ftt.gzip.compressor(out, level=6, meta=GzipMetadata(filename=b"x"))
    c.write(part1); c.flush()        # out now holds a decodable prefix
    c.write(part2); c.finish()

Each namespace runs the one-shot device encode (device/pipeline2.py
compress_device2, levels 1-9), the streaming device encode
(Compressor over pipeline2.DeviceEncoder) and the device decode
(device/inflate2.py, device/anyinflate.py) with its container.
"""

from __future__ import annotations

import io
from typing import Optional

import torch

from . import consts
from .containers import (Container, GzipMetadata, Hasher, write_footer,
                         write_header)
from .device import anyinflate, inflate2, pipeline2, resolve_device

# An empty stored block, byte-aligned, written on a fresh byte: the
# flush()/Z_SYNC_FLUSH marker (bits 000, pad, then 00 00 FF FF)
FLUSH_MARKER = b"\x00\x00\x00\xff\xff"


class Compressor:
    """Streaming device compressor: write()/flush()/finish(), reset(),
    set_writer(), close().

    Buffers input into batches of `batch` shards of `shard_len` bytes and
    encodes each on the device (pipeline2.DeviceEncoder).  Every shard
    stream ends byte-aligned, so everything written to the writer is a
    decodable prefix; flush() encodes what is buffered, or writes the sync
    marker when nothing is.  The header carries `meta` (gzip) or the preset
    `dictionary`'s id (zlib); the dictionary also primes the match
    context.  The container checksum is taken on the host as data is
    written."""

    def __init__(self, writer, container: Container = Container.RAW,
                 level: int = consts.LEVEL_DEFAULT, *,
                 meta: Optional[GzipMetadata] = None,
                 dictionary: Optional[bytes] = None,
                 shard_len: int = consts.SHARD_LEN, ctx: int = pipeline2.CTX,
                 batch: int = 64, device: str | torch.device = "cuda"):
        self._writer = writer
        self._container = container
        self._level = level
        self._meta = meta
        self._dictionary = dictionary
        self._shard_len, self._ctx, self._batch = shard_len, ctx, batch
        self._device = device
        self._start()

    def _start(self) -> None:
        # the encoder first: an unknown level or missing card raises before
        # the header is written
        self._enc = pipeline2.DeviceEncoder(
            level=self._level, shard_len=self._shard_len, ctx=self._ctx,
            batch=self._batch, dictionary=self._dictionary,
            device=self._device)
        self._hasher = Hasher(self._container)
        self._buf = bytearray()
        self._finished = False
        self._writer.write(write_header(self._container, self._meta,
                                        self._dictionary))

    def _check_open(self, what: str) -> None:
        if self._finished:
            raise ValueError(f"{what} after finish")

    def write(self, data: bytes) -> int:
        """Buffer `data`; encode and write every whole batch."""
        self._check_open("write")
        self._hasher.update(data)
        self._buf += data
        step = self._batch * self._shard_len
        while len(self._buf) >= step:
            chunk = bytes(self._buf[:step])
            del self._buf[:step]
            self._writer.write(self._enc.encode(chunk))
        return len(data)

    def flush(self) -> None:
        """Byte-sync everything written so far (network-protocol flush)."""
        self._check_open("flush")
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self._writer.write(self._enc.encode(chunk))
        else:
            self._writer.write(FLUSH_MARKER)

    def finish(self) -> None:
        """Encode the rest as the final block, then write the footer."""
        self._check_open("finish")
        chunk = bytes(self._buf)
        self._buf.clear()
        self._writer.write(self._enc.encode(chunk, final=True))
        self._writer.write(write_footer(self._container, self._hasher))
        self._finished = True

    def reset(self) -> None:
        """Start a new member on the same writer: header again, fresh
        encoder."""
        self._start()

    def set_writer(self, writer) -> None:
        """Swap the output sink mid-stream."""
        self._writer = writer

    def close(self) -> None:
        if not self._finished:
            self.finish()


class _Namespace:
    def __init__(self, container: Container):
        self._container = container

    def compressor(self, writer, level: int = consts.LEVEL_DEFAULT, *,
                   meta: Optional[GzipMetadata] = None,
                   dictionary: Optional[bytes] = None,
                   shard_len: int = consts.SHARD_LEN,
                   ctx: int = pipeline2.CTX, batch: int = 64,
                   device: str | torch.device = "cuda") -> Compressor:
        """A streaming Compressor of this container writing to `writer`."""
        return Compressor(writer, self._container, level, meta=meta,
                          dictionary=dictionary, shard_len=shard_len,
                          ctx=ctx, batch=batch, device=device)

    def compress(self, data, level: int = consts.LEVEL_DEFAULT, *,
                 writer=None, meta: Optional[GzipMetadata] = None,
                 dictionary: Optional[bytes] = None,
                 device: str | torch.device = "cuda",
                 shard_len: int = consts.SHARD_LEN,
                 ctx: int = pipeline2.CTX, batch: int = 64):
        """Compress `data` (bytes, or a reader read `batch` x `shard_len`
        bytes at a time) at level 1-9 into one member of this container.
        Returns the bytes, or writes them to `writer` and returns None.

        Bytes without `meta` and `dictionary` go through compress_device2
        (gzip: with the FLT1 shard index that lets the decode run
        shard-parallel); a reader, `meta` or `dictionary` stream through
        the Compressor."""
        kw = dict(shard_len=shard_len, ctx=ctx, batch=batch, device=device)
        is_bytes = isinstance(data, (bytes, bytearray, memoryview))
        if is_bytes and meta is None and dictionary is None:
            blob = pipeline2.compress_device2(
                bytes(data), level=level, container=self._container, **kw)
            if writer is None:
                return blob
            writer.write(blob)
            return None
        out = io.BytesIO() if writer is None else writer
        c = self.compressor(out, level, meta=meta, dictionary=dictionary,
                            **kw)
        if is_bytes:
            c.write(data)
        else:
            while chunk := data.read(batch * shard_len):
                c.write(chunk)
        c.finish()
        return out.getvalue() if writer is None else None

    def decompress(self, data: bytes, *,
                   device: str | torch.device = "cuda", batch: int = 8,
                   walk: str | None = None) -> bytes:
        """Decompress a stream of this container on `device`.

        Members that carry the encoder's FLT1 shard index decode
        shard-parallel, `batch` shards at a time (device/inflate2.py).  A
        member without a usable index (a foreign encoder's stream, zlib
        and raw streams, or shards over 128 KiB) decodes on the same
        device as chains of blocks, from bit 0 and from the first
        dynamic-block header the device scanner finds in each further
        512 KiB of the body (device/anyinflate.py, device/scan.py).
        There is no host decoder to fall back
        to, and the decode never leaves the named device on its own: a
        missing card raises DeviceUnavailable.

        walk: "lanes" (lane walk with join resolve) or "serial" (exact
        serial walk) for the indexed decode; None reads
        FLATE_TPU_INFLATE_WALK from the environment at call time and
        defaults to "lanes".  Checksums and sizes are verified; corrupt
        input raises the errors of flate_tpu_torch.errors."""
        dev = resolve_device(device)
        data = bytes(data)
        try:
            return inflate2.decompress_device(
                data, self._container, batch=batch, device=dev, walk=walk)
        except LookupError:
            return anyinflate.decompress_device_any(
                data, self._container, device=dev)


gzip = _Namespace(Container.GZIP)
zlib = _Namespace(Container.ZLIB)
flate = _Namespace(Container.RAW)
