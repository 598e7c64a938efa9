"""The round-1 compression pipeline over batches of shards.

Counterpart of flate_tpu/jx/pipeline.py: phase1 (:41), unpack_stats (:71),
phase2 (:80), phase2_bucketed (:93), build_windows (:102), fetch_words
(:113), _WordFetcher (:123), _packed_table (:148), _ShardPlan (:154),
_dynamic_header_fields (:163), plan_shards (:185), emit_shard (:239) and
compress_device (:286).  The host decides and splices; the heavy work is
two device phases:

  phase1 (device): match search (torch ops, kernels B3 and B4) -> token
                   walk (parse.parse_walk, kernel B9) -> token compaction
                   -> litlen/dist histograms
  host:            block kind per shard (stored / fixed / dynamic /
                   literal-only) and its Huffman codes, from the stats
                   fetched once a batch
  phase2 (device): bit-pack the token bodies with the chosen codes
                   (pack.pack_fields, kernel B5)
  host:            dynamic headers, end-of-block codes, sync-flush
                   markers, container framing and checksum

Shard shapes are fixed (ctx + shard_len bytes); the last partial shard
and empty input go through the host tail encoder (deflate.tokenize_shard)
with the same 32 KiB of context.  The bytes are the JAX package's for the
same (data, level, container, shard_len, ctx), at any batch, but for one
repair: a fixed block's literals 144-255 get the codes of the full fixed
table (_plan_codes).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import block, consts, huffman, tables
from ..bitpack import BitSink
from ..containers import Container, Hasher, write_footer, write_header
from ..deflate import tokenize_shard
from . import encode as enc
from . import match as mtc
from . import parse as prs
from . import resolve_device

CTX = mtc.CTX


def phase1(windows: torch.Tensor, ctx_lens: torch.Tensor, *, ctx: int,
           K: int, K3: int, lazy: bool, max_lazy: int, nwords: int = 8):
    """windows (B, ctx + shard_len) uint8 -> (token arrays, stats (B, 317)
    int64 = [litlen hist | dist hist | ntokens]): the small per-shard
    results in one tensor, fetched once."""
    mlen, mdist = mtc.find_matches_device(
        windows, ctx_lens, K=K, K3=K3, min_len=consts.MIN_MATCH_LEN,
        ctx=ctx, nwords=nwords)
    starts = prs.parse_walk(mlen, mdist, start=ctx, lazy=lazy,
                            max_lazy=max_lazy)
    take, _ = prs.decide(mlen, mdist, lazy, max_lazy)
    tok = enc.compact_tokens(windows[:, ctx:], mlen[:, ctx:], mdist[:, ctx:],
                             starts[:, ctx:], take[:, ctx:])
    ll, dd = enc.histograms(tok)
    return tok, torch.cat([ll, dd, tok["ntokens"][:, None]], dim=1)


def unpack_stats(stats: np.ndarray):
    """(hll, hdd, ntokens) from the packed phase1 stats array."""
    hll = stats[:, :consts.NUM_LITLEN]
    hdd = stats[:, consts.NUM_LITLEN:consts.NUM_LITLEN + consts.NUM_DIST]
    return hll, hdd, stats[:, -1]


def phase2(tok: dict, ll_packed: torch.Tensor, d_packed: torch.Tensor,
           nt: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack the token bodies with per-shard code tables (B, 286) / (B,
    30); with nt, only the first nt token slots (the caller's bucket).
    Returns (words (B, NWORDS) int32 bit patterns of u32, tbits (B,))."""
    if nt:
        tok = {k: (v[:, :nt] if v.dim() == 2 else v) for k, v in tok.items()}
    return enc.pack_tokens(tok, ll_packed, d_packed)


def phase2_bucketed(tok: dict, llp: np.ndarray, dp: np.ndarray, maxt: int):
    """phase2 over the smallest power-of-two token bucket >= maxt (at
    least 4096): shapes change with the bucket, bytes do not."""
    full = tok["live"].shape[1]
    nt = min(full, max(4096, 1 << (max(1, maxt - 1)).bit_length()))
    dev = tok["live"].device
    return phase2(tok, torch.from_numpy(llp).to(dev),
                  torch.from_numpy(dp).to(dev), nt=nt)


def build_windows(shards: torch.Tensor, ctx0: torch.Tensor, *,
                  ctx: int) -> torch.Tensor:
    """(B, S) shards -> (B, ctx + S) windows on the device: row b's
    context is row b-1's tail, row 0's the carry ctx0 (ctx <= S)."""
    S = shards.shape[1]
    tails = shards[:, S - ctx:]
    prev = torch.cat([ctx0[None, :], tails[:-1]], dim=0)
    return torch.cat([prev, shards], dim=1)


def _used_words(tbits: np.ndarray, nwords: int) -> int:
    """The power-of-two word prefix (at least 1024) that holds every
    row's tbits bits."""
    need = -(-int(tbits.max()) // 32) if tbits.size else 1
    return min(max(1024, 1 << (max(need, 1) - 1).bit_length()), nwords)


def fetch_words(words: torch.Tensor, tbits: np.ndarray) -> np.ndarray:
    """Host copy (u32) of the used prefix of the packed words."""
    n = _used_words(tbits, words.shape[1])
    return words[:, :n].cpu().numpy().view(np.uint32)


class _WordFetcher:
    """Fetch of the packed words that hides a round trip: a guessed
    prefix (the last batch's need) is copied to pinned memory while tbits
    comes over, and the rest only when the guess was short."""

    def __init__(self):
        self.guess = 1 << 14

    def __call__(self, words: torch.Tensor, tbits_dev: torch.Tensor
                 ) -> tuple[np.ndarray, np.ndarray]:
        g = min(self.guess, words.shape[1])
        part = words[:, :g]
        if part.is_cuda:
            host = torch.empty(part.shape, dtype=part.dtype,
                               pin_memory=True)
            host.copy_(part, non_blocking=True)
            part = host
        tbits = tbits_dev.cpu().numpy()        # waits for both copies
        n = _used_words(tbits, words.shape[1])
        self.guess = n
        if n <= g:
            return part[:, :n].numpy().view(np.uint32), tbits
        return fetch_words(words, tbits), tbits


def _packed_table(codes: np.ndarray, lens: np.ndarray, n: int) -> np.ndarray:
    t = np.zeros(n, dtype=np.uint32)
    t[:codes.size] = codes.astype(np.uint32) | (lens.astype(np.uint32) << 24)
    return t


class _ShardPlan:
    __slots__ = ("kind", "ll_lens", "d_lens")

    def __init__(self, kind, ll_lens=None, d_lens=None):
        self.kind = kind
        self.ll_lens = ll_lens
        self.d_lens = d_lens


def _dynamic_header_fields(final, ll_lens, d_lens):
    """(values, bits, total bits) of a dynamic block header."""
    cg_items, hlit, hdist = block.generate_codegen(ll_lens, d_lens)
    cg_freq = block._codegen_freq(cg_items)
    cg_lens = huffman.huffman_code_lengths(cg_freq, consts.MAX_CODEGEN_BITS)
    cg_codes = tables.canonical_codes(cg_lens)
    hclen = block._hclen(cg_lens)
    hv = [int(final) | (2 << 1), hlit - 257, hdist - 1, hclen - 4]
    hb = [3, 5, 5, 4]
    for i in range(hclen):
        hv.append(int(cg_lens[tables.CODEGEN_ORDER[i]]))
        hb.append(3)
    for sym, ev, eb in cg_items:
        hv.append(int(cg_codes[sym]))
        hb.append(int(cg_lens[sym]))
        if eb:
            hv.append(ev)
            hb.append(eb)
    return hv, hb, sum(hb)


def plan_shards(hists_ll: np.ndarray, hists_d: np.ndarray,
                shard_views: list[np.ndarray]) -> list[_ShardPlan]:
    """The cheapest block representation of each shard and its code
    lengths: dynamic, fixed, stored, or literal-only (LZ costs more than
    it saves, e.g. on digit streams; built only when the literals'
    entropy bound beats the token blocks)."""
    plans = []
    for b in range(hists_ll.shape[0]):
        freq_ll = hists_ll[b].astype(np.int64)
        freq_d = hists_d[b].astype(np.int64)
        ll_lens = huffman.huffman_code_lengths(freq_ll, consts.MAX_CODE_BITS)
        d_lens = huffman.huffman_code_lengths(freq_d, consts.MAX_CODE_BITS)
        if not d_lens.any():
            d_lens[0] = 1
        _, _, dyn_header = _dynamic_header_fields(False, ll_lens, d_lens)
        body = huffman.bit_length(freq_ll, ll_lens) + \
            huffman.bit_length(freq_d, d_lens) + \
            block._extra_bits_cost(freq_ll, freq_d)
        dyn = dyn_header + body
        fix = block.fixed_size(freq_ll, freq_d)
        sto = block.stored_size(shard_views[b].size, 0)
        lit = sto + 1
        lit_freq = np.bincount(shard_views[b], minlength=consts.NUM_LITLEN
                               ).astype(np.int64)[:consts.NUM_LITLEN]
        nz = lit_freq[lit_freq > 0]
        if nz.size:
            total = nz.sum()
            entropy_bits = float((nz * (np.log2(total) - np.log2(nz))).sum())
            if entropy_bits < min(dyn, fix):
                lit_freq[consts.END_OF_BLOCK] += 1
                lit_lens = huffman.huffman_code_lengths(
                    lit_freq, consts.MAX_CODE_BITS)
                lit_d = np.zeros(consts.NUM_DIST, dtype=np.int32)
                lit_d[0] = 1
                _, _, lit_header = _dynamic_header_fields(False, lit_lens,
                                                          lit_d)
                lit = lit_header + huffman.bit_length(lit_freq, lit_lens)

        best = min((dyn, "dynamic"), (fix, "fixed"), (sto, "stored"),
                   (lit, "literal"), key=lambda t: t[0])[1]
        if best == "dynamic":
            plans.append(_ShardPlan("dynamic", ll_lens, d_lens))
        elif best == "fixed":
            plans.append(_ShardPlan(
                "fixed",
                tables.FIXED_LITLEN_LENS[:consts.NUM_LITLEN].copy(),
                tables.FIXED_DIST_LENS[:consts.NUM_DIST].copy()))
        else:
            plans.append(_ShardPlan(best))
    return plans


def _plan_codes(plan: _ShardPlan) -> tuple[np.ndarray, np.ndarray]:
    """(litlen, dist) codes of a coded plan.  A fixed block's are the
    canonical codes of all 288 / 32 fixed lengths, as the decoder builds
    them: the codes of the first 286 lengths alone differ for literals
    144-255 (the JAX package's round-1 encoder emits those, and zlib
    rejects its fixed blocks that hold such a literal; ROADMAP C)."""
    if plan.kind == "fixed":
        return (tables.FIXED_LITLEN_CODES[:consts.NUM_LITLEN],
                tables.FIXED_DIST_CODES[:consts.NUM_DIST])
    return (tables.canonical_codes(plan.ll_lens),
            tables.canonical_codes(plan.d_lens))


def code_tables(plans: list[_ShardPlan], rows: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """(rows, 286) / (rows, 30) packed code tables (code | nbits << 24) of
    the coded plans; zero rows for the others."""
    llp = np.zeros((rows, consts.NUM_LITLEN), dtype=np.uint32)
    dp = np.zeros((rows, consts.NUM_DIST), dtype=np.uint32)
    for i, p in enumerate(plans):
        if p.kind in ("dynamic", "fixed"):
            ll_codes, d_codes = _plan_codes(p)
            llp[i] = _packed_table(ll_codes, p.ll_lens, consts.NUM_LITLEN)
            dp[i] = _packed_table(d_codes, p.d_lens, consts.NUM_DIST)
    return llp, dp


def emit_shard(sink: BitSink, plan: _ShardPlan, words: np.ndarray,
               tbits: int, shard_view: np.ndarray, final: bool) -> None:
    """Splice one shard's chosen representation into the stream."""
    if plan.kind == "stored":
        block.write_stored(sink, shard_view.tobytes(), final)
    elif plan.kind == "literal":
        block.write_block(sink, block.Tokens.literals(shard_view), final,
                          raw=shard_view.tobytes())
    else:
        if plan.kind == "fixed":
            hv, hb = [int(final) | (1 << 1)], [3]
        else:
            hv, hb, _ = _dynamic_header_fields(final, plan.ll_lens,
                                               plan.d_lens)
        sink.append_fields(np.asarray(hv, dtype=np.uint64),
                           np.asarray(hb, dtype=np.int64))
        sink.append_packed(words.copy(), tbits)
        eob = consts.END_OF_BLOCK
        sink.append_fields(
            np.asarray([_plan_codes(plan)[0][eob]], dtype=np.uint64),
            np.asarray([plan.ll_lens[eob]], dtype=np.int64))


def level_knobs(level: int) -> dict:
    """phase1's knobs of a level; ValueError for an unknown level."""
    if level not in consts.LEVEL_PARAMS:
        raise ValueError(f"invalid level {level}")
    K, _nice, lazy, max_lazy = consts.LEVEL_PARAMS[level]
    return dict(K=K, K3=min(8, K), lazy=lazy, max_lazy=max_lazy,
                nwords=16 if level >= 6 else 8)


def write_tail(sink: BitSink, arr: np.ndarray, nfull: int, shard_len: int,
               level: int) -> None:
    """The bytes past the last full shard (and empty input) as one final
    block from the host tail encoder, primed with up to 32 KiB before
    them."""
    rem = arr[nfull * shard_len:]
    if rem.size or nfull == 0:
        ctx_bytes = arr[max(0, nfull * shard_len - consts.MAX_DISTANCE):
                        nfull * shard_len]
        toks = tokenize_shard(rem, ctx_bytes if ctx_bytes.size else None,
                              level)
        block.write_block(sink, toks, final=True, raw=rem.tobytes())


def compress_device(data: bytes, level: int = consts.LEVEL_DEFAULT,
                    container: Container = Container.GZIP,
                    shard_len: int = consts.SHARD_LEN,
                    ctx: int = CTX, batch: int = 8,
                    device: str | torch.device = "cuda") -> bytes:
    """One-shot compress through the round-1 pipeline on `device` (the
    card by default; "cpu" runs the kernels' plain versions).  Raises
    DeviceUnavailable when the card is asked for and absent, ValueError
    for an unknown level or ctx > shard_len."""
    knobs = level_knobs(level)
    if ctx > shard_len:
        raise ValueError(f"ctx {ctx} exceeds shard_len {shard_len}")
    dev = resolve_device(device)
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size
    nfull = n // shard_len

    sink = BitSink()
    out = bytearray(write_header(container))
    hasher = Hasher(container)
    hasher.update(data)
    pin = dev.type == "cuda"

    def dispatch(base: int):
        """Enqueue phase1 of one batch: the card works on it while the
        host plans and splices the batch before."""
        nb = min(batch, nfull - base)
        lo0 = base * shard_len
        # the last batch is padded to the fixed shape
        host = torch.zeros((batch, shard_len), dtype=torch.uint8,
                           pin_memory=pin)
        shards_np = host.numpy()
        shards_np[:nb] = arr[lo0:lo0 + nb * shard_len].reshape(nb, shard_len)
        c0 = min(ctx, lo0)
        ctx0 = np.zeros(ctx, dtype=np.uint8)
        ctx0[ctx - c0:] = arr[lo0 - c0:lo0]
        ctx_lens = np.full(batch, ctx, dtype=np.int32)
        ctx_lens[0] = c0
        windows = build_windows(host.to(dev, non_blocking=True),
                                torch.from_numpy(ctx0).to(dev), ctx=ctx)
        tok, stats = phase1(windows, torch.from_numpy(ctx_lens).to(dev),
                            ctx=ctx, **knobs)
        return base, nb, [shards_np[i] for i in range(nb)], tok, stats

    fetch = _WordFetcher()
    bases = list(range(0, nfull, batch))
    inflight = dispatch(bases[0]) if bases else None
    for j in range(len(bases)):
        base, nb, shard_views, tok, stats = inflight
        if j + 1 < len(bases):
            inflight = dispatch(bases[j + 1])
        hll, hdd, ntokens = unpack_stats(stats.cpu().numpy())
        plans = plan_shards(hll[:nb], hdd[:nb], shard_views)
        llp, dp = code_tables(plans, batch)
        words, tbits = phase2_bucketed(tok, llp, dp, int(ntokens[:nb].max()))
        words, tbits = fetch(words, tbits)
        for i, p in enumerate(plans):
            final = (base + i == nfull - 1) and (n % shard_len == 0)
            emit_shard(sink, p, words[i], int(tbits[i]), shard_views[i],
                       final)
            if not final:
                block.write_flush_marker(sink)

    write_tail(sink, arr, nfull, shard_len, level)
    sink.align_to_byte()
    out += sink.getvalue()
    out += write_footer(container, hasher)
    return bytes(out)
