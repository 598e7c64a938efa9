"""Arithmetic length/distance codes (RFC 1951 §3.2.5) and the round-1
encoder's token stages.

Counterpart of flate_tpu/jx/encode.py: the code functions (:25-62), and
compact_tokens (:64), histograms (:110) and pack_tokens (:128), batch-wise
torch ops on the device:

- token compaction: a per-row cumsum of the token starts and one scatter;
- per-shard litlen/dist histograms: one scatter-add;
- bit-packing: pack.pack_fields over four fields a token (every field is
  <= 15 bits wide), kernel B5 on the card.

Inputs and outputs are integer tensors; extra values are int64, the
packed words int32 bit patterns of u32.
"""

from __future__ import annotations

import torch

from .. import consts
from . import pack

FIELDS = 4                       # litlen code, len extra, dist code, dist extra


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for integer x >= 1 (exact: frexp of a float64)."""
    return torch.frexp(x.to(torch.float64)).exponent.to(torch.int64) - 1


def length_code(length: torch.Tensor) -> torch.Tensor:
    """Match length (3..258) -> length code index (0..28)."""
    n = length.to(torch.int64) - 3
    e = torch.clamp(_floor_log2(torch.clamp(n, min=1)) - 2, min=1)
    code = torch.where(n < 8, n, (e << 2) + (n >> e))
    return torch.where(n == 255, 28, code)


def length_extra(length: torch.Tensor, code: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(extra value, extra bits) for a length code."""
    code = code.to(torch.int64)
    ebits = torch.where((code < 8) | (code == 28), 0,
                        torch.clamp((code >> 2) - 1, min=0))
    base = torch.where(code < 8, code + 3, ((4 + (code & 3)) << ebits) + 3)
    base = torch.where(code == 28, 258, base)
    return torch.clamp(length.to(torch.int64) - base, min=0), ebits


def dist_code(dist: torch.Tensor) -> torch.Tensor:
    """Distance (1..32768) -> distance code (0..29)."""
    m = dist.to(torch.int64) - 1
    e = _floor_log2(torch.clamp(m, min=1))
    hi = (e << 1) + ((m >> torch.clamp(e - 1, min=0)) & 1)
    return torch.where(m < 4, m, hi)


def dist_extra(dist: torch.Tensor, code: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    code = code.to(torch.int64)
    ebits = torch.clamp((code >> 1) - 1, min=0)
    base = torch.where(code < 4, code + 1, ((2 + (code & 1)) << ebits) + 1)
    return torch.clamp(dist.to(torch.int64) - base, min=0), ebits


def compact_tokens(window: torch.Tensor, mlen: torch.Tensor,
                   mdist: torch.Tensor, starts: torch.Tensor,
                   take: torch.Tensor) -> dict:
    """Parsed token streams -> (B, MAXT) token arrays, MAXT = the shard
    length (tokens never outnumber bytes).  Every position that starts no
    token goes to the dead column MAXT, which is dropped; slots past
    ntokens carry zero-width fields in the packer."""
    B, W = window.shape
    dev = window.device
    MAXT = W
    slot = torch.cumsum(starts.to(torch.int64), dim=1) - 1
    ntokens = slot[:, -1] + 1
    tgt = torch.where(starts, slot, MAXT)
    flat = (torch.arange(B, dtype=torch.int64, device=dev)[:, None]
            * (MAXT + 1) + tgt).reshape(-1)

    def scat(vals):
        out = torch.zeros(B * (MAXT + 1), dtype=vals.dtype, device=dev)
        out[flat] = vals.reshape(-1)
        return out.reshape(B, MAXT + 1)[:, :MAXT]

    live = (torch.arange(MAXT, dtype=torch.int64, device=dev)[None, :]
            < ntokens[:, None])
    is_m = scat(take & starts) & live
    tlen = torch.clamp(scat(mlen.to(torch.int64)), min=3)
    tdist = torch.clamp(scat(mdist.to(torch.int64)), min=1)
    tlit = scat(window).to(torch.int64)

    lcode = length_code(tlen)
    lev, leb = length_extra(tlen, lcode)
    dcode = dist_code(tdist)
    dev_, deb = dist_extra(tdist, dcode)
    llsym = torch.where(is_m, 257 + lcode, tlit)
    return {
        "ntokens": ntokens,
        "live": live,
        "is_match": is_m,
        "llsym": torch.where(live, llsym, 0),
        "len_ev": lev, "len_eb": torch.where(is_m, leb, 0),
        "dsym": dcode, "dist_ev": dev_,
        "dist_eb": torch.where(is_m, deb, 0),
    }


def histograms(tok: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 286) litlen frequencies with the end-of-block and (B, 30)
    distance frequencies, int64."""
    live, is_m = tok["live"], tok["is_match"]
    B = live.shape[0]
    dev = live.device
    rows = torch.arange(B, dtype=torch.int64, device=dev)[:, None]
    ll = torch.zeros(B * consts.NUM_LITLEN, dtype=torch.int64, device=dev)
    ll.index_add_(0, (rows * consts.NUM_LITLEN + tok["llsym"]).reshape(-1),
                  live.reshape(-1).to(torch.int64))
    ll = ll.reshape(B, consts.NUM_LITLEN)
    ll[:, consts.END_OF_BLOCK] += 1
    dd = torch.zeros(B * consts.NUM_DIST, dtype=torch.int64, device=dev)
    dsym = torch.where(is_m, tok["dsym"], 0)
    dd.index_add_(0, (rows * consts.NUM_DIST + dsym).reshape(-1),
                  is_m.reshape(-1).to(torch.int64))
    return ll, dd.reshape(B, consts.NUM_DIST)


def pack_tokens(tok: dict, ll_packed: torch.Tensor, d_packed: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-pack the batch's token bodies.  ll_packed / d_packed: (B, 286)
    / (B, 30) integer tables, entry = code | (nbits << 24).  Returns
    (words (B, NWORDS) int32 bit patterns of u32, total_bits (B,) int32);
    NWORDS covers the worst case of 48 bits a token.  The (value, width)
    fields go through pack.pack_fields, kernel B5 on the card; a dead
    field has width zero and value zero."""
    is_m, live = tok["is_match"], tok["live"]
    B, MAXT = live.shape
    NWORDS = MAXT * 48 // 32 + 4

    lle = torch.gather(ll_packed.to(torch.int64), 1, tok["llsym"])
    dde = torch.gather(d_packed.to(torch.int64), 1, tok["dsym"])
    vals = torch.stack([
        lle & 0xFFFFFF,
        tok["len_ev"],
        torch.where(is_m, dde & 0xFFFFFF, 0),
        tok["dist_ev"],
    ], dim=2).reshape(B, MAXT * FIELDS)
    bits = torch.stack([
        torch.where(live, lle >> 24, 0),
        tok["len_eb"],
        torch.where(is_m, dde >> 24, 0),
        tok["dist_eb"],
    ], dim=2).reshape(B, MAXT * FIELDS)
    vals = torch.where(bits > 0, vals, 0)     # a literal's extras are junk
    words, total_bits = pack.pack_fields(vals, bits, -(-NWORDS // 128))
    return words.reshape(B, -1)[:, :NWORDS], total_bits
