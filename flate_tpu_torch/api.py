"""Public surface of the PyTorch port.

    import flate_tpu_torch as ftt
    blob = ftt.gzip.compress(data, level=6)              # on the CUDA card
    blob = ftt.zlib.compress(data, level=3, device="cpu")
    blob = ftt.zlib.compress(data, dictionary=d)         # FDICT member
    data = ftt.gzip.decompress(blob)                     # on the CUDA card
    data = ftt.zlib.decompress(blob, dictionary=d, device="cpu")
    ftt.gzip.decompress(reader, writer)                  # streams

    c = ftt.gzip.compressor(out, level=6, meta=GzipMetadata(filename=b"x"))
    c.write(part1); c.flush()        # out now holds a decodable prefix
    c.write(part2); c.finish()

    d = ftt.gzip.decompressor(reader)                    # on the CUDA card
    while chunk := d.read(1 << 20): ...

Each namespace (gzip, zlib, flate) has the JAX package's surface:
compress, decompress, compressor, decompressor, Compressor, Decompressor
and the huffman / store sub-modes.  It runs the one-shot device encode
(device/pipeline2.py compress_device2, levels 1-9), the streaming device
encode (Compressor over pipeline2.DeviceEncoder) and the device decode
(device/inflate2.py, device/anyinflate.py) with its container.  The
huffman and store modes write their blocks on the host, as the JAX
package does; their streams decode on the device like any other.
"""

from __future__ import annotations

import collections
import io
import time
from types import SimpleNamespace
from typing import Optional

import torch

from . import consts, metrics
from .bitpack import BitSink
from .block import write_flush_marker, write_huffman_only, write_stored
from .containers import (Container, GzipMetadata, Hasher, parse_footer,
                         parse_header, write_footer, write_header)
from .device import anyinflate, inflate2, pipeline2, resolve_device
from .errors import EndOfStream
from .shard_index import parse_index_extra

# An empty stored block, byte-aligned, written on a fresh byte: the
# flush()/Z_SYNC_FLUSH marker (bits 000, pad, then 00 00 FF FF)
FLUSH_MARKER = b"\x00\x00\x00\xff\xff"

_BYTES = (bytes, bytearray, memoryview)


class Compressor:
    """Streaming compressor: write()/flush()/finish(), reset(),
    set_writer(), close().

    mode "deflate" (the default) buffers input into batches of `batch`
    shards of `shard_len` bytes and encodes each on the device
    (pipeline2.DeviceEncoder).  Every shard stream ends byte-aligned, so
    everything written to the writer is a decodable prefix; flush()
    encodes what is buffered, or writes the sync marker when nothing is.
    The header carries `meta` (gzip) or the preset `dictionary`'s id
    (zlib); the dictionary also primes the match context.

    The huffman_only() and store_only() compressors (modes "huffman" and
    "store") write literal-only or stored blocks on the host, a block a
    `shard_len` shard, each followed by the sync marker, as the JAX
    package's Compressor does.  The container checksum is taken on the
    host as data is written."""

    def __init__(self, writer, container: Container = Container.RAW,
                 level: int = consts.LEVEL_DEFAULT, *,
                 meta: Optional[GzipMetadata] = None,
                 dictionary: Optional[bytes] = None,
                 shard_len: int = consts.SHARD_LEN, ctx: int = pipeline2.CTX,
                 batch: int = 64, device: str | torch.device = "cuda",
                 mode: str = "deflate"):
        if mode not in ("deflate", "huffman", "store"):
            raise ValueError(f"unknown mode {mode!r}")
        self._writer = writer
        self._container = container
        self._level = level
        self._meta = meta
        self._dictionary = dictionary
        self._shard_len, self._ctx, self._batch = shard_len, ctx, batch
        self._device = device
        self._mode = mode
        self._start()

    @classmethod
    def huffman_only(cls, writer, container: Container = Container.RAW,
                     meta: Optional[GzipMetadata] = None) -> "Compressor":
        """A compressor of literal-only blocks (no matches)."""
        return cls(writer, container, meta=meta, mode="huffman")

    @classmethod
    def store_only(cls, writer, container: Container = Container.RAW,
                   meta: Optional[GzipMetadata] = None) -> "Compressor":
        """A compressor of stored blocks."""
        return cls(writer, container, meta=meta, mode="store")

    def _start(self) -> None:
        # the encoder first: an unknown level or missing card raises before
        # the header is written
        self._enc = None
        if self._mode == "deflate":
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

    def _host_shard(self, n: int, final: bool) -> None:
        """Write the first `n` buffered bytes as one huffman or store
        block, then the sync marker unless final (a bare marker when
        there is nothing to write)."""
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        sink = BitSink()
        if chunk or final:
            if self._mode == "store":
                write_stored(sink, chunk, final)
            else:
                write_huffman_only(sink, chunk, final)
        if final:
            sink.align_to_byte()
        else:
            write_flush_marker(sink)
        self._writer.write(sink.getvalue())

    def write(self, data: bytes) -> int:
        """Buffer `data`; encode and write every whole batch (every shard
        but the last buffered one, in the host modes)."""
        self._check_open("write")
        self._hasher.update(data)
        self._buf += data
        if self._enc is None:
            while len(self._buf) > self._shard_len:
                self._host_shard(self._shard_len, final=False)
            return len(data)
        step = self._batch * self._shard_len
        while len(self._buf) >= step:
            chunk = bytes(self._buf[:step])
            del self._buf[:step]
            self._writer.write(self._enc.encode(chunk))
        return len(data)

    def flush(self) -> None:
        """Byte-sync everything written so far (network-protocol flush)."""
        self._check_open("flush")
        if self._enc is None:
            self._host_shard(len(self._buf), final=False)
        elif self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self._writer.write(self._enc.encode(chunk))
        else:
            self._writer.write(FLUSH_MARKER)

    def finish(self) -> None:
        """Encode the rest as the final block, then write the footer."""
        self._check_open("finish")
        if self._enc is None:
            self._host_shard(len(self._buf), final=True)
        else:
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


class _Member:
    """Where the streaming decode of one member stands."""

    __slots__ = ("body", "bit", "hist", "entries", "carry", "done")

    def __init__(self, body: int, hist: bytes, entries):
        self.body = body             # stream offset of the member body
        self.bit = 0                 # the next step's bit in the body
        self.hist = hist             # last CTX bytes of history
        self.entries = entries       # FLT1 shard starts (body bits) or None
        # the block the next step goes on with at `bit` (an
        # anyinflate.BlockPlan), or None at a block boundary
        self.carry = None
        self.done = False            # the final block is decoded


class Decompressor:
    """Streaming device decompressor: read(n)/read_all()/decompress(writer),
    reset(), at_end(), set_reader().

    A reader is pulled FETCH bytes at a time and the consumed prefix is
    dropped past TRIM.  Each step decodes the member's next WINDOW
    compressed bytes on the device (anyinflate.decode_step): chains from
    the bit where the last step stopped and from the scanner's entry in
    each eighth of a whole window (at most anyinflate.CHUNK_BYTES apart;
    a shorter window, at the end of the input, is cut into as many
    chunks of at least anyinflate.SPAN0), or from the FLT1 shard offsets
    where the gzip header has them, with the member's last 32 KiB of
    output (or its preset dictionary) as history.
    A block that runs past the window is decoded up to the window's end
    and handed on to the next step, which starts inside it (a coded
    block's tables, or the rest of a stored block's length), so input
    memory stays at most TRIM + WINDOW + FETCH bytes whatever the stream's
    size and its blocks' lengths, as the JAX package's Decompressor keeps
    its input at O(TRIM).  Only at the end of the input does a block that
    runs off it raise its error (EndOfStream for a block cut short).

    Output is bounded too: a step decodes its window's chain on the
    device and leaves its symbols unresolved there (at most CHAIN_CAP
    bytes of output at a block's end); read(n) resolves them in stream
    order one batch of at most OUT_CAP bytes at a time, only while it
    holds fewer than n bytes, and the next step starts once the chain is
    drained.  So the decoder holds at most OUT_CAP bytes of output that
    it has not served plus the n bytes a read asks for (decompress(writer)
    OUT_CAP + CHUNK), whatever the member's size and ratio, as the JAX
    package's native stream holds O(64 KiB); `stats["output_peak"]` is
    the most it held.  A match that reaches before the history raises
    when its batch is resolved, after the bytes before it were served.
    Payload is checksummed as it is served; the footer is checked on the
    read after the last payload byte.  reset() goes on with the next
    concatenated member."""

    CHUNK = 1 << 16              # decompress(writer)'s read size
    FETCH = 1 << 20              # reader pull granularity
    TRIM = 1 << 22               # drop the consumed prefix beyond this
    WINDOW = 8 << 20             # compressed bytes a decode step covers
    OUT_CAP = anyinflate.MAX_S   # resolved output held unserved at most
    # output bytes a step's chain decodes at most: bounds the symbol words
    # it holds on the device for a window of a high ratio
    CHAIN_CAP = 64 << 20

    def __init__(self, reader, container: Container = Container.RAW,
                 verify: bool = True, dictionary: Optional[bytes] = None, *,
                 device: str | torch.device = "cuda"):
        self._dev = resolve_device(device)
        self._container = container
        self._verify = verify
        self._dictionary = dictionary
        # the input not yet dropped, as fetched: whole chunks, so that
        # dropping a prefix or adding a fetch copies nothing
        self._chunks: collections.deque = collections.deque()
        self._held = 0           # bytes in self._chunks
        if isinstance(reader, _BYTES):
            self._src, self._eof = None, True
            self._add(bytes(reader))
        else:
            self._src, self._eof = reader, False
        self._base = 0           # stream offset of the first chunk
        self._pos = 0            # stream offset of the member (or its end)
        # steps, input_peak, output_peak
        self.stats: collections.Counter = collections.Counter()
        self.reset()

    # -- input ------------------------------------------------------------
    def _add(self, chunk: bytes) -> None:
        self._chunks.append(chunk)
        self._held += len(chunk)

    def _fetch(self) -> bool:
        """Pull one chunk from the source; False at its end."""
        if self._eof:
            return False
        chunk = self._src.read(self.FETCH)
        if not chunk:
            self._eof = True
            return False
        self._add(bytes(chunk))
        self.stats["input_peak"] = max(self.stats["input_peak"], self._held)
        return True

    def _end(self) -> int:
        return self._base + self._held

    def _fill(self, upto: int) -> None:
        """Fetch until the input reaches stream offset `upto` or ends."""
        while self._end() < upto and self._fetch():
            pass

    def _slice(self, lo: int, hi: int) -> bytearray:
        """The input's bytes at stream offsets [lo, hi) that it holds (a
        bytearray, which the chunk-entry scanner takes without a copy)."""
        parts, at = [], self._base
        for c in self._chunks:
            if at >= hi:
                break
            if at + len(c) > lo:
                parts.append(memoryview(c)[max(lo - at, 0):hi - at])
            at += len(c)
        return bytearray().join(parts)

    def _trim(self) -> None:
        """Drop the chunks wholly before the input still needed once the
        consumed prefix passes TRIM."""
        keep = self._pos
        if self._m is not None and not self._member_done:
            keep = self._m.body + (self._m.bit >> 3)
        if keep - self._base < self.TRIM:
            return
        while self._chunks and self._base + len(self._chunks[0]) <= keep:
            c = self._chunks.popleft()
            self._base += len(c)
            self._held -= len(c)

    # -- one member ---------------------------------------------------------
    def _start_member(self) -> None:
        while True:
            try:
                hdr, meta = parse_header(
                    self._container, self._slice(self._pos, self._end()),
                    allow_dict=self._dictionary is not None)
                break
            except EndOfStream:
                if not self._fetch():
                    raise
        entries = None
        idx = parse_index_extra(meta.extra) if meta and meta.extra else None
        if idx is not None:
            comp_lens = idx[0]
            entries = [8 * int(s) for s in comp_lens.cumsum() - comp_lens]
        self._m = _Member(self._pos + hdr,
                          anyinflate.history(self._dictionary), entries)
        self._hasher = Hasher(self._container)

    def _step(self) -> None:
        """Decode the member's next window into the output buffer."""
        m = self._m
        b0 = m.body + (m.bit >> 3)
        hi = b0 + self.WINDOW
        self._fill(hi)
        win = self._slice(b0, hi)
        start = m.bit & 7
        entries = None
        if m.entries is not None:
            entries = [e - 8 * (b0 - m.body) for e in m.entries]
        # as many scanner chains as a whole window has, however full, but
        # chunks no shorter than a block's first span: a stream that fits
        # one needs no scan
        full = min(anyinflate.CHUNK_BYTES, max(self.WINDOW // 8, 1))
        chains = -(-self.WINDOW // full)
        kw = dict(carry=m.carry, entries=entries, device=self._dev,
                  chunk_bytes=max(-(-len(win) // chains),
                                  min(full, anyinflate.SPAN0)),
                  chain_cap=self.CHAIN_CAP, out_cap=self.OUT_CAP)
        res, stop, done, carry = anyinflate.decode_step(
            win, start, m.hist, final_input=False, **kw)
        if stop == start and not done:
            if self._end() > hi or not self._eof:
                raise ValueError(f"a block header does not fit the "
                                 f"{self.WINDOW}-byte window")
            # the input has ended inside a block: its own error
            res, stop, done, carry = anyinflate.decode_step(
                win, start, m.hist, final_input=True, **kw)
        self.stats["steps"] += 1
        m.bit = 8 * (b0 - m.body) + stop
        m.carry, m.done = carry, done
        self._res = res
        self._trim()

    def _resolve(self) -> bool:
        """Resolve the next batch of the step's chain into the output, the
        member's next step first where the chain is drained (its history
        is then the chain's last CTX bytes); False once the member's whole
        output is resolved."""
        m = self._m
        while True:
            if self._res is None:
                if m.done:
                    return False
                self._step()
            part = next(self._res, None)
            if part is not None:
                break
            m.hist = self._res.hist
            self._res = None
        self._out.append(part)
        self._pending += len(part)
        self.stats["output_peak"] = max(self.stats["output_peak"],
                                        self._pending)
        return True

    def _finish_member(self) -> None:
        """Check the footer and move past it."""
        m = self._m
        end = m.body + (m.bit + 7) // 8
        if self._container is not Container.RAW:
            size = self._container.footer_size
            self._fill(end + size)
            if self._verify:
                size = parse_footer(self._container,
                                    self._slice(end, end + size),
                                    self._hasher)
            elif self._end() < end + size:
                raise EndOfStream("footer truncated")
            end += size
        self._pos = end
        self._member_done = True

    # -- public -------------------------------------------------------------
    def read(self, n: int = -1) -> bytes:
        """Up to `n` bytes of the member (all of it when n < 0); b"" once
        the member has been served and its footer checked."""
        if self._member_done:
            return b""
        if self._m is None:
            self._start_member()
        while (n < 0 or self._pending < n) and self._resolve():
            pass
        want = self._pending if n < 0 else min(n, self._pending)
        parts = []
        while want:
            part = memoryview(self._out[0])
            k = min(want, len(part) - self._out_pos)
            parts.append(part[self._out_pos:self._out_pos + k])
            want -= k
            if self._out_pos + k == len(part):
                self._out.popleft()
                self._out_pos = 0
            else:
                self._out_pos += k
        chunk = b"".join(parts)
        self._pending -= len(chunk)
        if self._verify:
            self._hasher.update(chunk)
        else:
            self._hasher.nbytes += len(chunk)
        if self._m.done and self._res is None and not self._pending \
                and (n < 0 or not chunk):
            self._finish_member()
        return chunk

    def read_all(self) -> bytes:
        return self.read(-1)

    def decompress(self, writer) -> None:
        """Stream the member to `writer`, CHUNK bytes a write."""
        while chunk := self.read(self.CHUNK):
            writer.write(chunk)

    def reset(self) -> None:
        """Prepare for the next concatenated member."""
        self._m: Optional[_Member] = None
        self._hasher: Optional[Hasher] = None
        self._member_done = False
        # the steps' output parts not yet served, the first from _out_pos
        self._out: collections.deque = collections.deque()
        self._out_pos = 0
        self._pending = 0
        # the resolve of the last step's chain (anyinflate.Resolve) until
        # it is drained
        self._res = None

    def at_end(self) -> bool:
        """Whether no input follows the last finished member."""
        self._fill(self._pos + 1)
        return self._pos >= self._end()

    def set_reader(self, reader) -> None:
        """Go on with more input, mid-member too: bytes are appended to the
        input; a file-like object becomes the source pulled from."""
        if not isinstance(reader, _BYTES):
            self._src, self._eof = reader, False
            return
        self._add(bytes(reader))
        self._trim()


def decode_members(data: bytes, container: Container, verify: bool = True,
                   dictionary: Optional[bytes] = None, *,
                   device: str | torch.device = "cuda", batch: int = 8,
                   walk: str | None = None) -> bytes:
    """Every member of `data`, in order, on the device: one with the FLT1
    index shard-parallel (inflate2), any other as chains of blocks
    (anyinflate).  Bytes after a member are read as the next member, so
    trailing bytes that are not one raise.  With a dictionary, the one
    member at the start (chained, with the dictionary as its history),
    as the JAX package decodes it."""
    dev = resolve_device(device)
    if dictionary is not None:
        out, _ = anyinflate._decompress_member_any(
            data, 0, container, verify, dev, dictionary=dictionary)
        return out
    out = bytearray()
    offset = 0
    while offset < len(data):
        t = time.perf_counter()
        try:
            chunk, end = inflate2.decompress_member_device(
                data, offset, container, batch, verify, device=dev,
                walk=walk)
            op = "device.decompress_indexed"
        except LookupError:
            chunk, end = anyinflate._decompress_member_any(
                data, offset, container, verify, dev)
            op = "device.decompress_any"
        metrics.record(op, end - offset, len(chunk), time.perf_counter() - t)
        out += chunk
        offset = end
    return bytes(out)


class _Namespace:
    def __init__(self, container: Container):
        self.container = container
        self._name = container.name.lower()
        self.Compressor = Compressor
        self.Decompressor = Decompressor
        self.huffman = self._sub_mode("huffman")
        self.store = self._sub_mode("store")

    def _sub_mode(self, mode: str) -> SimpleNamespace:
        def compress(data, writer=None, meta=None):
            return self._compress(data, writer, meta, mode=mode)

        def compressor(writer, meta=None):
            return Compressor(writer, self.container, meta=meta, mode=mode)

        return SimpleNamespace(compress=compress, decompress=self.decompress,
                               compressor=compressor,
                               decompressor=self.decompressor)

    def compressor(self, writer, level: int = consts.LEVEL_DEFAULT, *,
                   meta: Optional[GzipMetadata] = None,
                   dictionary: Optional[bytes] = None,
                   shard_len: int = consts.SHARD_LEN,
                   ctx: int = pipeline2.CTX, batch: int = 64,
                   device: str | torch.device = "cuda") -> Compressor:
        """A streaming Compressor of this container writing to `writer`."""
        return Compressor(writer, self.container, level, meta=meta,
                          dictionary=dictionary, shard_len=shard_len,
                          ctx=ctx, batch=batch, device=device)

    def decompressor(self, reader, verify: bool = True,
                     dictionary: Optional[bytes] = None, *,
                     device: str | torch.device = "cuda") -> Decompressor:
        """A streaming Decompressor of this container reading `reader`
        (bytes or a file-like object)."""
        return Decompressor(reader, self.container, verify, dictionary,
                            device=device)

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
        return self._compress(data, writer, meta, level=level,
                              dictionary=dictionary, shard_len=shard_len,
                              ctx=ctx, batch=batch, device=device)

    def _compress(self, data, writer, meta, *, mode: str = "deflate",
                  level: int = 0, dictionary=None, **kw):
        is_bytes = isinstance(data, _BYTES)
        nbytes = len(data) if is_bytes else 0
        with metrics.timed(f"{self._name}.compress", nbytes, level=level,
                           mode=mode) as m:
            if is_bytes and mode == "deflate" and meta is None \
                    and dictionary is None:
                blob = pipeline2.compress_device2(
                    bytes(data), level=level, container=self.container,
                    **kw)
            else:
                out = io.BytesIO() if writer is None else writer
                c = Compressor(out, self.container, level, meta=meta,
                               dictionary=dictionary, mode=mode, **kw)
                if is_bytes:
                    c.write(data)
                else:
                    step = c._shard_len * (c._batch if c._enc else 1)
                    while chunk := data.read(step):
                        c.write(chunk)
                c.finish()
                if writer is not None:
                    return None
                blob = out.getvalue()
            m["bytes_out"] = len(blob)
        if writer is None:
            return blob
        writer.write(blob)
        return None

    def decompress(self, data, writer=None, verify: bool = True,
                   dictionary: Optional[bytes] = None, *,
                   device: str | torch.device = "cuda", batch: int = 8,
                   walk: str | None = None):
        """Decompress a stream of this container on `device`: bytes, or a
        reader.  Returns the bytes, or writes them to `writer` and returns
        None; a reader with a writer streams through the Decompressor,
        member after member, in bounded memory.

        Members that carry the encoder's FLT1 shard index decode
        shard-parallel, `batch` shards at a time (device/inflate2.py).  A
        member without a usable index (a foreign encoder's stream, zlib
        and raw streams, or shards over 128 KiB) decodes on the same
        device as chains of blocks, from bit 0 and from the first
        dynamic-block header the device scanner finds in each further
        512 KiB of the body (device/anyinflate.py, device/scan.py).
        Every concatenated member is decoded; bytes after the last that
        are not a member raise.  A `dictionary` is the preset history of
        the one member decoded (zlib: the FDICT member's).  There is no
        host decoder to fall back to, and the decode never leaves the
        named device on its own: a missing card raises DeviceUnavailable.

        walk: "lanes" (lane walk with join resolve) or "serial" (exact
        serial walk) for the indexed decode; None reads
        FLATE_TPU_INFLATE_WALK from the environment at call time and
        defaults to "lanes".  Checksums and sizes are verified unless
        verify=False; corrupt input raises the errors of
        flate_tpu_torch.errors."""
        dev = resolve_device(device)
        if not isinstance(data, _BYTES) and writer is not None:
            with metrics.timed(f"{self._name}.decompress", 0):
                d = self.decompressor(data, verify, dictionary, device=dev)
                while True:
                    d.decompress(writer)
                    if d.at_end():
                        break
                    d.reset()
            return None
        raw = bytes(data) if isinstance(data, _BYTES) else data.read()
        with metrics.timed(f"{self._name}.decompress", len(raw)) as m:
            out = decode_members(raw, self.container, verify, dictionary,
                                 device=dev, batch=batch, walk=walk)
            m["bytes_out"] = len(out)
        if writer is None:
            return out
        writer.write(out)
        return None


gzip = _Namespace(Container.GZIP)
zlib = _Namespace(Container.ZLIB)
flate = _Namespace(Container.RAW)
