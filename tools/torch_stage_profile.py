"""Stage times of the PyTorch port's encode and decode on one CUDA card.

    python3 tools/torch_stage_profile.py [--level 6] [--reps 3]
    python3 tools/torch_stage_profile.py --decode [--level 3] [--reps 3]

Runs the stages of flate_tpu_torch.device.pipeline2.encode_batch_packed
one by one on an 8 MiB batch (64 shards of 128 KiB after 32 KiB of
context; bench.py's mixed corpus, as chip_smoke.py makes it), with
torch.cuda.synchronize() and a host clock around each, and prints one JSON
line per level (--level may be given several times; default 1, 3 and 6):
the stage milliseconds (median over reps), the steps of the block walk
(kernel B9), the whole batch's time, and the device-busy share of one
whole-batch run from torch.profiler (sum of CUDA kernel time over wall
time).  At a level with the squeeze cost DP its three parts are timed
apart: the greedy code lengths, the DP, and the DP's token-start walk.

With --decode it encodes chip_smoke.py's text corpus at each level and
times the indexed decode of its first batch (8 shards of 128 KiB) stage by
stage: host planning (index parse, plan_shard, pack_coded_run with its
copy to the card), _pass1, the lane walk, _extract, _resolve, and the
fetch of flags and bytes; then the whole text decode and the serial-walk
batch, and the device-busy share of one whole decode.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import B, CTX, S, mixed_corpus, smi, text_corpus  # noqa: E402
from flate_tpu_torch import api  # noqa: E402
from flate_tpu_torch.containers import Container, parse_header  # noqa: E402
from flate_tpu_torch.device import encode2, inflate2, match2, pack  # noqa: E402
from flate_tpu_torch.device import parse, pipeline2, squeeze  # noqa: E402
from flate_tpu_torch.shard_index import parse_index_extra  # noqa: E402


def stages(shards, ctx0, meta, kern):
    """One batch, stage by stage; returns {stage: ms}."""
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) * 1e3
        return r

    K, nw, lazy, max_lazy, K3, blk = (kern[k] for k in (
        "K", "nw", "lazy", "max_lazy", "K3", "blk"))
    ctx_lens, valid = meta[:B], meta[B:2 * B]
    finals, nb = meta[2 * B:3 * B], meta[3 * B]
    win = timed("prime", lambda: pipeline2._prime_windows(shards, ctx0, CTX))
    min_src = (CTX - ctx_lens).to(torch.int32)
    limit = (CTX + valid).to(torch.int32)
    key, words = timed("prep", lambda: match2._prep(win, nw, 4))
    skey, order = timed("sort", lambda: torch.sort(key, dim=1))
    ld = timed("matcher", lambda: match2._run_matcher(
        skey, order, words, min_src, limit, win.shape[1], K, 32768))
    if K3:
        def k3_pass():
            ld3 = match2._candidate_pass(win, min_src, limit, K=K3, nw=1,
                                         hash_bytes=3, max_dist=4096)
            l3, d3 = torch.clamp(ld3 >> 16, max=3), ld3 & 0xFFFF
            upd = match2._score(l3, d3) > match2._score(ld >> 16,
                                                        ld & 0xFFFF)
            return torch.where(upd, (l3 << 16) | d3, ld)
        ld = timed("k3_pass", k3_pass)
    rl, rd = timed("small_runs",
                   lambda: match2.runs.small_dist_runs(win, limit, min_src))

    def merge():
        ml, md = ld >> 16, ld & 0xFFFF
        upd = match2._score(rl, rd) > match2._score(ml, md)
        return (torch.where(upd, rl, ml).contiguous(),
                torch.where(upd, rd, md).contiguous())
    ml, md = timed("merge", merge)
    ml = timed("extend", lambda: match2.runs.extend_chains(ml, md, limit,
                                                           4 * nw))
    ml, md = timed("truncate_decide", lambda: parse.truncate_matches(
        ml, md, CTX, blk))
    take, _ = parse.decide(ml, md, lazy, max_lazy)
    starts = timed("parse_blocks", lambda: parse.parse_blocks(
        ml, md, start=CTX, lazy=lazy, max_lazy=max_lazy, blk=blk))
    wt, m_r, d_r = win[:, CTX:], ml[:, CTX:], md[:, CTX:]
    take_r, starts_r = take[:, CTX:], starts[:, CTX:]
    if kern["squeeze"]:
        ll, dd = timed("squeeze_greedy_lengths",
                       lambda: squeeze.greedy_code_lengths(
                           wt, m_r, d_r, starts_r, take_r, valid))
        # squeeze_parse ends in the block walk: time the walk alone on
        # its output and take it off
        take_r, starts_r, sel = timed(
            "squeeze_dp", lambda: squeeze.squeeze_parse(
                wt, m_r, d_r, ll, dd, blk=blk))
        sel_rows = sel.reshape(-1, blk).contiguous()
        timed("squeeze_walk", lambda: parse._parse_walk(sel_rows))
        out["squeeze_dp"] -= out["squeeze_walk"]
        m_r = torch.where(take_r, sel, 0)
    seg = encode2.seg_size(S, blk)
    vals, bits, _, _ = timed("build_fields", lambda: encode2.build_fields(
        wt, m_r, d_r, starts_r, take_r, valid, finals, S, seg))
    words_, tbits = timed("pack", lambda: pack.pack_fields(
        vals, bits, pipeline2._nwr(S, seg)))
    buf, meta_out = timed("compact_crc", lambda: pipeline2._compact_stage(
        words_, tbits, shards, valid, nb, pipeline2.HASH_CRC32))
    timed("fetch", lambda: buf[:int(meta_out[0])].cpu())
    return out


def walk_steps(ml, md, kern) -> dict:
    """Steps the block walk takes on this batch: all rows, and the longest
    row (the serial depth of kernel B9)."""
    _, step = parse.decide(ml, md, kern["lazy"], kern["max_lazy"])
    mask = parse._parse_walk(
        step[:, CTX:].to(torch.int32).reshape(-1, kern["blk"]).contiguous())
    return {"rows": mask.shape[0], "steps": int(mask.sum()),
            "longest_row": int(mask.sum(dim=1).max())}


def device_busy(fn) -> dict:
    """Wall ms, summed device ms and the largest device items of one
    profiled fn()."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    evs = prof.key_averages()
    total = sum(dev_us(e) for e in evs)
    top = sorted(evs, key=lambda e: -dev_us(e))[:8]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": total / 1e3,
            "device_busy_share": total / 1e3 / wall_ms,
            "top_device_ops": [(e.key, dev_us(e) / 1e3, e.count)
                               for e in top]}


def decode_stages(blob: bytes, dev, nshards: int = 8) -> dict:
    """The indexed decode of the member's first `nshards` shards, stage by
    stage with a synchronise around each; returns {stage: ms}."""
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) * 1e3
        return r

    def plan():
        hdr, meta = parse_header(Container.GZIP, blob)
        comp_lens, out_lens, _ = parse_index_extra(meta.extra)
        run, off = [], hdr
        for c, o in zip(comp_lens[:nshards], out_lens[:nshards]):
            sh = blob[off:off + int(c)]
            off += int(c)
            run.append((inflate2.plan_shard(sh, int(o)), sh))
        return run
    run = timed("host_plan", plan)
    a = timed("host_pack_and_copy",
              lambda: inflate2.pack_coded_run(run, b"", dev))
    word = timed("pass1", lambda: inflate2._pass1(a[0], *a[3:9]))
    mask, joined = timed("lane_walk",
                         lambda: inflate2._lane_walk(word, a[2], 8 * a[1]))
    ex = timed("extract", lambda: inflate2._extract(
        word, mask, joined, a[2], S + 128))
    o, err = timed("resolve", lambda: inflate2._resolve(
        ex[0], ex[1], a[9], a[10], S))
    timed("fetch", lambda: (inflate2._pack_flags(err, ex[2]).cpu(), o.cpu()))
    timed("serial_walk", lambda: inflate2._walk(word, a[2], 8 * a[1],
                                                S + 128))
    return out


def decode_profile(levels, reps: int, card: str) -> None:
    dev = torch.device("cuda")
    text = text_corpus(3_359_630)
    for level in levels:
        blob = api.gzip.compress(text, level=level)
        runs_ = [decode_stages(blob, dev) for _ in range(reps + 1)][1:]
        med = {k: statistics.median(r[k] for r in runs_) for k in runs_[0]}
        walk = med.pop("serial_walk")
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = api.gzip.decompress(blob)
            secs.append(time.perf_counter() - t)
            if got != text:
                raise AssertionError("decode differs from the input")
        whole = statistics.median(secs)
        inflate2.STATS.clear()
        busy = device_busy(lambda: api.gzip.decompress(blob))
        print(json.dumps({
            "card": card, "mode": "decode", "level": level,
            "batch_shards": 8, "batch_bytes": 8 * S, "stage_ms": med,
            "stage_sum_ms": sum(med.values()), "serial_walk_ms": walk,
            "text_bytes": len(text), "text_decode_s": whole,
            "text_decode_GBps": len(text) / whole / 1e9,
            "stats": dict(inflate2.STATS), **busy}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, action="append")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--decode", action="store_true",
                    help="profile the decode instead of the encode")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = smi()
    if args.decode:
        decode_profile(args.level or [1, 3], args.reps, card)
        return 0
    head = mixed_corpus(CTX + B * S)     # context, then one 8 MiB batch
    ctx0 = torch.frombuffer(bytearray(head[:CTX]), dtype=torch.uint8).to(dev)
    shards = torch.frombuffer(bytearray(head[CTX:]), dtype=torch.uint8
                              ).reshape(B, S).to(dev)
    meta = torch.zeros(3 * B + 1, dtype=torch.int32)
    meta[:B] = CTX
    meta[B:2 * B] = S
    meta[3 * B] = B
    meta = meta.to(dev)
    for level in args.level or [1, 3, 6]:
        kern = pipeline2.level_params(level, S)
        runs_ = [stages(shards, ctx0, meta, kern) for _ in
                 range(args.reps + 1)][1:]
        med = {k: statistics.median(r[k] for r in runs_) for k in runs_[0]}
        win = pipeline2._prime_windows(shards, ctx0, CTX)
        ml, md = match2.find_matches_fused(win, meta[:B], meta[B:2 * B],
                                           K=kern["K"], nw=kern["nw"],
                                           ctx=CTX, K3=kern["K3"])
        ml, md = parse.truncate_matches(ml, md, CTX, kern["blk"])
        steps = walk_steps(ml, md, kern)

        def whole():
            buf, mo = pipeline2.encode_batch_packed(
                shards, ctx0, meta, S=S, ctx=CTX,
                hash_kind=pipeline2.HASH_CRC32, **kern)
            return buf[:int(mo[0])].cpu()
        whole()
        torch.cuda.synchronize()
        t = time.perf_counter()
        whole()
        batch_ms = (time.perf_counter() - t) * 1e3
        busy = device_busy(whole)
        print(json.dumps({
            "card": card, "level": level, "batch_bytes": B * S,
            "stage_ms": med, "stage_sum_ms": sum(med.values()),
            "block_walk": steps, "batch_ms": batch_ms,
            **busy}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
