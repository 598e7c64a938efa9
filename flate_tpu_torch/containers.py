"""Container framing: raw / gzip (RFC 1952) / zlib (RFC 1950).  Headers
and footers are a handful of host bytes around the device-produced (or
device-decoded) payload; parsing raises the container's exact error class
on malformed input."""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from . import checksums
from .errors import (
    BadGzipHeader,
    BadZlibHeader,
    EndOfStream,
    WrongGzipChecksum,
    WrongGzipSize,
    WrongZlibChecksum,
)


class Container(Enum):
    RAW = "raw"
    GZIP = "gzip"
    ZLIB = "zlib"

    @property
    def header_size(self) -> int:
        return {Container.RAW: 0, Container.GZIP: 10, Container.ZLIB: 2}[self]

    @property
    def footer_size(self) -> int:
        return {Container.RAW: 0, Container.GZIP: 8, Container.ZLIB: 4}[self]


@dataclass
class GzipMetadata:
    """Optional gzip header metadata."""
    filename: Optional[bytes] = None
    comment: Optional[bytes] = None
    extra: Optional[bytes] = None
    mtime: int = 0
    os: int = 3  # unix
    text: bool = False
    hcrc: bool = False  # write FHCRC: CRC16 of the header bytes


@dataclass
class Hasher:
    """Running container checksum + byte counter.  The device encoder
    feeds it per-shard checksums through the combine operators; the
    decoder feeds it the decoded bytes through update()."""
    container: Container
    value: int = field(default=0)
    nbytes: int = 0

    def __post_init__(self):
        if self.container is Container.ZLIB:
            self.value = 1

    def update(self, data: bytes) -> None:
        self.nbytes += len(data)
        if self.container is Container.GZIP:
            self.value = checksums.crc32(data, self.value)
        elif self.container is Container.ZLIB:
            self.value = checksums.adler32(data, self.value)

    def chksum(self) -> int:
        return self.value & 0xFFFFFFFF


FLG_FTEXT = 1
FLG_FHCRC = 2
FLG_FEXTRA = 4
FLG_FNAME = 8
FLG_FCOMMENT = 16


def write_header(container: Container, meta: Optional[GzipMetadata] = None,
                 dictionary: Optional[bytes] = None) -> bytes:
    """The container's header bytes.  gzip carries `meta` (and ignores
    `dictionary`); zlib with a preset dictionary sets FDICT and appends its
    DICTID (RFC 1950 §2.2); raw has none."""
    if container is Container.GZIP:
        if meta is None:
            # fixed 10-byte header: magic, CM=deflate, no flags, mtime=0,
            # XFL=0, OS=3/unix
            return bytes([0x1F, 0x8B, 0x08, 0x00, 0, 0, 0, 0, 0x00, 0x03])
        flags = 0
        if meta.text:
            flags |= FLG_FTEXT
        if meta.hcrc:
            flags |= FLG_FHCRC
        if meta.extra is not None:
            flags |= FLG_FEXTRA
        if meta.filename is not None:
            flags |= FLG_FNAME
        if meta.comment is not None:
            flags |= FLG_FCOMMENT
        out = bytearray([0x1F, 0x8B, 0x08, flags])
        out += struct.pack("<I", meta.mtime & 0xFFFFFFFF)
        out += bytes([0x00, meta.os & 0xFF])
        if meta.extra is not None:
            out += struct.pack("<H", len(meta.extra)) + meta.extra
        if meta.filename is not None:
            out += meta.filename + b"\x00"
        if meta.comment is not None:
            out += meta.comment + b"\x00"
        if meta.hcrc:
            out += struct.pack("<H", zlib.crc32(bytes(out)) & 0xFFFF)
        return bytes(out)
    if container is Container.ZLIB:
        if dictionary is not None:
            # FDICT set: recompute FCHECK, append DICTID
            flg = 0x20 | (2 << 6)
            flg |= (31 - ((0x78 << 8 | flg) % 31)) % 31
            return bytes([0x78, flg]) + struct.pack(
                ">I", checksums.adler32(dictionary))
        # CM=8 CINFO=7 (32K window), FLEVEL=default, FCHECK -> 0x78 0x9c
        return bytes([0x78, 0x9C])
    return b""


def write_footer(container: Container, hasher: Hasher) -> bytes:
    if container is Container.GZIP:
        return struct.pack("<II", hasher.chksum(), hasher.nbytes & 0xFFFFFFFF)
    if container is Container.ZLIB:
        return struct.pack(">I", hasher.chksum())
    return b""


def parse_header(container: Container, data: bytes,
                 allow_dict: bool = False) -> tuple[int, Optional[GzipMetadata]]:
    """Parse and validate a container header.

    Returns (bytes_consumed, metadata).  Raises the container's exact error
    class on malformed input, EndOfStream if the buffer is too short.
    """
    if container is Container.RAW:
        return 0, None
    if container is Container.GZIP:
        if len(data) < 10:
            raise EndOfStream("gzip header truncated")
        magic1, magic2, method, flags = data[0], data[1], data[2], data[3]
        if magic1 != 0x1F or magic2 != 0x8B or method != 0x08 or (flags & 0xE0) != 0:
            raise BadGzipHeader(f"bad gzip header bytes {data[:4].hex()}")
        meta = GzipMetadata(
            mtime=struct.unpack("<I", data[4:8])[0],
            os=data[9],
            text=bool(flags & FLG_FTEXT),
        )
        pos = 10
        try:
            if flags & FLG_FEXTRA:
                (xlen,) = struct.unpack("<H", data[pos:pos + 2])
                meta.extra = bytes(data[pos + 2:pos + 2 + xlen])
                if len(meta.extra) != xlen:
                    raise EndOfStream("gzip FEXTRA truncated")
                pos += 2 + xlen
            if flags & FLG_FNAME:
                end = data.index(b"\x00", pos)
                meta.filename = bytes(data[pos:end])
                pos = end + 1
            if flags & FLG_FCOMMENT:
                end = data.index(b"\x00", pos)
                meta.comment = bytes(data[pos:end])
                pos = end + 1
            if flags & FLG_FHCRC:
                if len(data) < pos + 2:
                    raise EndOfStream("gzip FHCRC truncated")
                (hcrc,) = struct.unpack("<H", data[pos:pos + 2])
                actual = checksums.crc32(bytes(data[:pos])) & 0xFFFF
                if hcrc != actual:
                    raise BadGzipHeader("gzip header CRC mismatch")
                pos += 2
        except (struct.error, ValueError) as e:
            raise EndOfStream("gzip header truncated") from e
        return pos, meta
    # zlib
    if len(data) < 2:
        raise EndOfStream("zlib header truncated")
    cmf, flg = data[0], data[1]
    cm = cmf & 0x0F
    cinfo = cmf >> 4
    fdict = bool(flg & 0x20)
    if cm != 8 or cinfo > 7 or ((cmf << 8) | flg) % 31 != 0 or \
            (fdict and not allow_dict):
        raise BadZlibHeader(f"bad zlib header bytes {data[:2].hex()}")
    if fdict:
        if len(data) < 6:
            raise EndOfStream("zlib DICTID truncated")
        return 6, None  # 2 header bytes + 4-byte DICTID (Adler32 of dict)
    return 2, None


def parse_footer(container: Container, data: bytes, hasher: Hasher) -> int:
    """Validate footer bytes against the rolling hasher; return bytes
    consumed.  Raises the container's exact error class on a mismatch."""
    if container is Container.RAW:
        return 0
    if container is Container.GZIP:
        if len(data) < 8:
            raise EndOfStream("gzip footer truncated")
        crc, isize = struct.unpack("<II", data[:8])
        if crc != hasher.chksum():
            raise WrongGzipChecksum(f"{crc:#x} != {hasher.chksum():#x}")
        if isize != (hasher.nbytes & 0xFFFFFFFF):
            raise WrongGzipSize(f"{isize} != {hasher.nbytes}")
        return 8
    if len(data) < 4:
        raise EndOfStream("zlib footer truncated")
    (adler,) = struct.unpack(">I", data[:4])
    if adler != hasher.chksum():
        raise WrongZlibChecksum(f"{adler:#x} != {hasher.chksum():#x}")
    return 4
