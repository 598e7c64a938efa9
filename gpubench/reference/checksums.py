"""CRC-32 (RFC 1952) and Adler-32 (RFC 1950), written from the RFCs in
NumPy.

CRC-32 runs the byte-at-a-time table update on many lanes of the data at
once, each lane from a register of 0, and joins the lanes with the
operator that advances a register over a run of zero bytes (CRC-32 is
linear over GF(2)): the same value as one register over all the bytes."""

from __future__ import annotations

import numpy as np

POLY = 0xEDB88320                   # the reflected CRC-32 polynomial
MOD_ADLER = 65521


def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(POLY), t >> 1)
    return t.astype(np.uint32)


TABLE = _crc_table()


def _step(reg: int) -> int:
    """The register after one zero byte."""
    return int(TABLE[reg & 0xFF]) ^ (reg >> 8)


def _zeros_operator(n: int) -> list[int]:
    """Column j: the register after n zero bytes from the register 1 << j
    (the advance is linear, so a register's image is the XOR of its bits'
    columns)."""
    one = [_step(1 << j) for j in range(32)]      # one zero byte

    def compose(a, b):                            # a after b
        return [_apply(a, col) for col in b]

    result = [1 << j for j in range(32)]          # the identity
    power = one
    while n:
        if n & 1:
            result = compose(power, result)
        power = compose(power, power)
        n >>= 1
    return result


def _apply(op: list[int], reg: int) -> int:
    out = 0
    j = 0
    while reg:
        if reg & 1:
            out ^= op[j]
        reg >>= 1
        j += 1
    return out


def crc32(data: bytes, lanes: int = 512) -> int:
    """CRC-32 of `data` as gzip stores it."""
    a = np.frombuffer(data, dtype=np.uint8)
    width = -(-len(a) // lanes) if len(a) else 0
    reg = 0xFFFFFFFF
    if width:
        full = len(a) // width
        body = a[:full * width].reshape(full, width)
        regs = np.zeros(full, dtype=np.uint32)
        for j in range(width):
            regs = TABLE[(regs ^ body[:, j]) & 0xFF] ^ (regs >> 8)
        op = _zeros_operator(width)
        for r in regs.tolist():
            reg = _apply(op, reg) ^ r
        for b in a[full * width:].tolist():
            reg = int(TABLE[(reg ^ b) & 0xFF]) ^ (reg >> 8)
    return reg ^ 0xFFFFFFFF


def adler32(data: bytes) -> int:
    """Adler-32 of `data` as zlib stores it: s1 = 1 + the sum of the bytes,
    s2 = the sum of s1 after each byte, both mod 65521."""
    a = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    n = len(a)
    s1 = (1 + int(a.sum())) % MOD_ADLER
    # s2 = n + sum over i of (n - i) * a[i], in blocks that fit int64
    s2 = n % MOD_ADLER
    step = 1 << 20
    for lo in range(0, n, step):
        w = np.arange(n - lo, max(n - lo - step, 0), -1, dtype=np.int64)
        s2 = (s2 + int((w[:len(a[lo:lo + step])] * a[lo:lo + step]).sum())
              ) % MOD_ADLER
    return s2 << 16 | s1
