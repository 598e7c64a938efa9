"""Bit-pack of (value, nbits) fields into LSB-first u32 words.

Counterpart of flate_tpu/jx/pack.py:pack_fields (:66).  For CUDA tensors
the whole function is CUDA kernel B5 (csrc/encode_kernels.cu): the offsets
(exclusive prefix sums of the field widths) come from the kernel's own
single-pass scan, and only its buffer is zeroed beside it.  For CPU tensors
the plain version: a cumsum, then a scatter-add (fields occupy disjoint
bits, so sums equal ORs).
"""

from __future__ import annotations

import torch

from .. import _build
from . import to_i32

PACK_TILE = 4096        # fields a block of B5 takes (kPackTile)


def _place_plain(vals: torch.Tensor, off: torch.Tensor,
                 nwords: int) -> torch.Tensor:
    """vals (B, SLOTS) u32 values (int64, or int32 bit patterns; dead
    fields zero), off (B, SLOTS) exclusive bit offsets -> (B, nwords)
    int32 u32 words; bits at or past word nwords are dropped."""
    B = vals.shape[0]
    off = off.to(torch.int64)
    word = off >> 5
    sh = off & 31
    v = vals.to(torch.int64) & 0xFFFFFFFF
    v0 = (v << sh) & 0xFFFFFFFF
    v1 = torch.where(sh == 0, 0, v >> torch.remainder(32 - sh, 32))
    acc = torch.zeros((B, nwords + 2), dtype=torch.int64, device=vals.device)
    acc.scatter_add_(1, torch.clamp(word, max=nwords + 1), v0)
    acc.scatter_add_(1, torch.clamp(word + 1, max=nwords + 1), v1)
    return to_i32(acc[:, :nwords])


def _pack_plain(vals: torch.Tensor, bits: torch.Tensor, nwords: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: offsets by cumsum, then `_place_plain`;
    returns (words (B, nwords), total_bits (B,) int32)."""
    incl = torch.cumsum(bits, dim=1, dtype=torch.int32)
    return _place_plain(vals, incl - bits, nwords), incl[:, -1]


def _pack_cuda(vals: torch.Tensor, bits: torch.Tensor, nwords: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B5.  One zeroed buffer holds the words, the tiles' status
    words and ticket, and total_bits."""
    B, slots = vals.shape
    _build.check_cuda("pack.vals", vals, torch.int32, (B, slots))
    _build.check_cuda("pack.bits", bits, torch.int32, (B, slots))
    tiles = -(-slots // PACK_TILE)
    n_words = B * nwords
    at_status = n_words + (n_words & 1)          # 8-byte aligned
    at_total = at_status + 2 * B * tiles + 2     # after the ticket
    buf = torch.zeros(at_total + B, dtype=torch.int32, device=vals.device)
    ptr = buf.data_ptr()
    _build.launch("flate_pack", vals.data_ptr(), bits.data_ptr(), ptr,
                  ptr + 4 * at_total, ptr + 4 * at_status, B, slots, nwords)
    return buf[:n_words].view(B, nwords), buf[at_total:]


def pack_fields(vals: torch.Tensor, bits: torch.Tensor, nwr: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """vals (B, SLOTS) u32 values as int32 bit patterns (dead fields zero;
    int64 u32 values are narrowed here), bits (B, SLOTS) int32 widths (<=
    28).  Returns (words (B, nwr, 128) int32 u32 bit patterns, total_bits
    (B,) int32); words past the stream are zero, bits past nwr * 128 words
    are dropped."""
    B = vals.shape[0]
    if vals.dtype == torch.int64:
        vals = to_i32(vals)
    vals = vals.contiguous()
    bits = bits.to(torch.int32).contiguous()
    if _build.use_plain(vals):
        words, total = _pack_plain(vals, bits, nwr * 128)
    else:
        words, total = _pack_cuda(vals, bits, nwr * 128)
    return words.reshape(B, nwr, 128), total
