"""Per-shard CRC32 / Adler32 on the device, plus the host fixups.

Counterpart of flate_tpu/jx/checksum.py: _crc32_rows_any (:102) and
_adler_rows_any (:242), with copies of padded_width (:112), crc32_fixup
(:128) and adler_finalize (:250), and the public crc32_shards (:145),
crc32_device (:190), adler32_shards (:259) and adler32_device (:267).
The container checksum comes from these per-shard values combined on the
host; no host pass reads the whole input.

CRC32 here is a tree over 4-byte words: the linear (init 0, no xorout)
CRC of each word by slice tables, then log2 rounds of
lin(A||B) = Z_|B|(lin(A)) ^ lin(B), where Z_k (advance by k zero bytes)
is applied as four byte-indexed table lookups.  Leading zero words do not
change a linear CRC, so rows are front-padded to a power of two words.
The standard CRC of the padded row is lin ^ crc32(zeros of that width).
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from ..checksums import ADLER_MOD, CRC_TABLE, adler32_combine, crc32_combine
from . import resolve_device

LANES = 256                      # the JAX kernel's lane split (row padding)
_M32 = 0xFFFFFFFF


def padded_width(S: int) -> int:
    """Row width _crc32_rows_any hashes (for crc32_fixup)."""
    return S + ((-S) % (4 * LANES))


def _apply_cols_np(cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y = M @ x over GF(2) for u32 vectors x; cols (32,) columns of M."""
    y = np.zeros_like(x)
    for i in range(32):
        y ^= np.where((x >> np.uint64(i)) & np.uint64(1), cols[i],
                      np.uint64(0))
    return y


@functools.lru_cache(maxsize=None)
def _zero_shift_tables(log2_bytes: int) -> np.ndarray:
    """(4, 256) u32: T[k][v] = Z(v << 8k), Z = advance a linear CRC
    register by 2**log2_bytes zero bytes."""
    # columns of Z_1 (one zero byte), squared log2_bytes times
    cols = np.asarray([(s >> 8) ^ int(CRC_TABLE[s & 0xFF])
                       for s in (1 << i for i in range(32))], dtype=np.uint64)
    for _ in range(log2_bytes):
        cols = _apply_cols_np(cols, cols.copy())
    v = np.arange(256, dtype=np.uint64)
    return np.stack([_apply_cols_np(cols, v << np.uint64(8 * k))
                     for k in range(4)]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _slice_tables() -> np.ndarray:
    """(4, 256): T[k][v] = linear CRC of byte v followed by k zero bytes."""
    tabs = np.zeros((4, 256), dtype=np.uint64)
    tabs[0] = CRC_TABLE
    for k in range(1, 4):
        prev = tabs[k - 1]
        tabs[k] = (prev >> np.uint64(8)) ^ CRC_TABLE[(prev & 0xFF).astype(
            np.int64)]
    return tabs.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _device_tables(log2_bytes: int | None, device: torch.device
                   ) -> torch.Tensor:
    """`_slice_tables()` (log2_bytes None) or `_zero_shift_tables` on
    `device`, made once per device so that no call copies from host
    memory (a CUDA graph captures none)."""
    tabs = (_slice_tables() if log2_bytes is None
            else _zero_shift_tables(log2_bytes))
    return torch.from_numpy(tabs).to(device)


def _lookup4(tabs: torch.Tensor, x: torch.Tensor, order) -> torch.Tensor:
    """XOR of tabs[order[k]][byte k of x] over the four bytes of x."""
    y = tabs[order[0]][x & 0xFF]
    for k in range(1, 4):
        y = y ^ tabs[order[k]][(x >> (8 * k)) & 0xFF]
    return y


def _crc32_rows_any(rows: torch.Tensor) -> torch.Tensor:
    """rows (B, S) uint8 -> (B,) int64 standard crc32 of each row
    zero-padded to padded_width(S).  Callers fix up with crc32_fixup."""
    B, S = rows.shape
    Sp = padded_width(S)
    dev = rows.device
    nwords = Sp // 4
    P = 1 << max(0, (nwords - 1).bit_length())
    b = torch.nn.functional.pad(rows, (0, Sp - S)).to(torch.int64)
    b = b.reshape(B, nwords, 4)
    word = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    word = torch.nn.functional.pad(word, (P - nwords, 0))
    crc = _lookup4(_device_tables(None, dev), word, (3, 2, 1, 0))
    nbytes_log2 = 2                                # each leaf covers 4 bytes
    while crc.shape[1] > 1:
        z = _device_tables(nbytes_log2, dev)
        pairs = crc.reshape(B, -1, 2)
        crc = _lookup4(z, pairs[:, :, 0], (0, 1, 2, 3)) ^ pairs[:, :, 1]
        nbytes_log2 += 1
    return (crc[:, 0] ^ zlib.crc32(bytes(Sp))) & _M32


def _adler_rows_any(rows: torch.Tensor, lens: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """rows (B, S) uint8 zero-padded + lens (B,) -> raw (s1, s2) (B,)
    int64 sums without the standard init (see adler_finalize)."""
    B, S = rows.shape
    pos = torch.arange(S, dtype=torch.int64, device=rows.device)[None, :]
    lens = lens.to(torch.int64)[:, None]
    d = torch.where(pos < lens, rows.to(torch.int64), 0)
    s1 = d.sum(dim=1) % ADLER_MOD
    s2 = ((lens - pos) * d).sum(dim=1) % ADLER_MOD
    return s1, s2


# ---------------------------------------------------------------------------
# host fixups
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cols_zero_bytes_final(k: int) -> np.ndarray:
    """Finalized-crc shift by k zero bytes (crc32_combine(x, 0, k) is
    linear in x): its 32 columns."""
    z = crc32_combine(0, 0, k)
    return np.asarray([crc32_combine(1 << i, 0, k) ^ z for i in range(32)],
                      dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _inv_cols_final(p: int) -> np.ndarray:
    """Inverse of the finalized-crc p-zero-byte shift matrix (GF(2))."""
    cols = _cols_zero_bytes_final(p)
    m = np.zeros((32, 32), dtype=np.uint8)
    for i in range(32):
        for j in range(32):
            m[j, i] = (int(cols[i]) >> j) & 1
    aug = np.concatenate([m, np.eye(32, dtype=np.uint8)], axis=1)
    for c in range(32):
        piv = next(r for r in range(c, 32) if aug[r, c])
        aug[[c, piv]] = aug[[piv, c]]
        for r in range(32):
            if r != c and aug[r, c]:
                aug[r] ^= aug[c]
    inv = aug[:, 32:]
    return np.asarray(
        [int("".join(map(str, inv[::-1, i])), 2) for i in range(32)],
        dtype=np.uint32)


def _unshift_final(crc_padded: int, p: int) -> int:
    x = crc_padded ^ (zlib.crc32(bytes(p)) & _M32)
    cols = _inv_cols_final(p)
    y = 0
    for i in range(32):
        if (x >> i) & 1:
            y ^= int(cols[i])
    return y & _M32


def crc32_fixup(full: np.ndarray, lens: np.ndarray, S: int) -> np.ndarray:
    """Per-row crc of the full zero-padded row of width S -> crc of the
    first lens[b] bytes (inverts the pad-zeros shift)."""
    full = np.asarray(full, dtype=np.uint32)
    lens = np.asarray(lens, dtype=np.int64)
    out = np.zeros(full.shape[0], dtype=np.uint32)
    for b in range(full.shape[0]):
        p = int(S - lens[b])
        out[b] = full[b] if p == 0 else _unshift_final(int(full[b]), p)
    return out


def adler_finalize(s1: np.ndarray, s2: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
    """Fold the standard init (s1 starts at 1) into raw device sums."""
    lens = np.asarray(lens, dtype=np.int64)
    s1 = (np.asarray(s1).astype(np.int64) + 1) % ADLER_MOD
    s2 = (np.asarray(s2).astype(np.int64) + lens % ADLER_MOD) % ADLER_MOD
    return ((s2 << 16) | s1).astype(np.uint32)


# ---------------------------------------------------------------------------
# public: per-row and whole-buffer checksums on the device
# ---------------------------------------------------------------------------

ROW = 1 << 20           # crc32_device / adler32_device hash rows of 1 MiB


def crc32_shards(rows: np.ndarray, lens: np.ndarray,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """(B, S) uint8 rows, zero past lens[b] -> (B,) uint32 standard crc32
    of each row's first lens[b] bytes: the rows are hashed on `device`,
    the ragged tails fixed up on the host.  Any S (the JAX function takes
    multiples of 4 * LANES)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    full = _crc32_rows_any(torch.from_numpy(rows).to(resolve_device(device)))
    return crc32_fixup(full.cpu().numpy(), lens,
                       padded_width(rows.shape[1]))


def adler32_shards(rows: np.ndarray, lens: np.ndarray,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """(B, S) uint8 rows, zero past lens[b] -> (B,) uint32 standard
    adler32 of each row's first lens[b] bytes, summed on `device`."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    dev = resolve_device(device)
    lens = np.asarray(lens, dtype=np.int64)
    s1, s2 = _adler_rows_any(torch.from_numpy(rows).to(dev),
                             torch.from_numpy(lens).to(dev))
    return adler_finalize(s1.cpu().numpy(), s2.cpu().numpy(), lens)


def _as_rows(data) -> tuple[np.ndarray, np.ndarray]:
    """A buffer as zero-padded rows of ROW bytes and their lengths."""
    arr = np.frombuffer(data, np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    n = arr.size
    nrows = -(-n // ROW)
    width = min(ROW, n)
    rows = np.zeros(nrows * width, dtype=np.uint8)
    rows[:n] = arr.reshape(-1)
    lens = np.minimum(width, n - width * np.arange(nrows))
    return rows.reshape(nrows, width), lens


def crc32_device(data, device: str | torch.device = "cuda") -> int:
    """Standard crc32 of a whole buffer: rows of up to 1 MiB hashed on
    `device`, combined on the host in order."""
    rows, lens = _as_rows(data)
    crc = 0
    if rows.size:
        for v, ln in zip(crc32_shards(rows, lens, device), lens):
            crc = crc32_combine(crc, int(v), int(ln))
    return crc


def adler32_device(data, device: str | torch.device = "cuda") -> int:
    """Standard adler32 of a whole buffer (1 for no bytes): rows of up to
    1 MiB summed on `device`, combined on the host in order."""
    rows, lens = _as_rows(data)
    adl = 1
    if rows.size:
        for v, ln in zip(adler32_shards(rows, lens, device), lens):
            adl = adler32_combine(adl, int(v), int(ln))
    return adl
