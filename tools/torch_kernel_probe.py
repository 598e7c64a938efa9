"""Where the time of kernels B1, B2, B3, B5, B6, B7, B9, B10 and the
squeeze's cost DP goes.

    python3 tools/torch_kernel_probe.py [--reps 20]

Needs a CUDA card.  Prints the card's name and power limit, then one line
per measurement (mean of --reps launches by CUDA events, after one warm-up),
and last one JSON object with every number.

B2, on the level-6 inputs of chip_smoke.py's first 8 MiB batch (64 shards
of 128 KiB after 32 KiB of context, the last shard cut to a tail): the
matcher at K = 0 (staging and the output stores alone: every row is
written, no candidate is read), 1, 4, 16 and 48 with level 6's 8 exact
words, at K = 48 with 1, 2, 3 and 6 words (3 and 6: rows staged with 4
and 8 words, the length cut at 4*ne), at level 9's knobs (K = 160, 16
words), and in fp/top-2 mode (K = 48, nw = 8: 2 exact + 2 fingerprint
words, both outputs).  The differences between K's are the scan's share.

B10, on 64 rows of 2^18 seeded random keys and 8 operands (the probe's
payload): the full network with no operand (the passes alone) and with 8
(the passes, then the gather), the empty list (two copies), each
planned pass of the full network alone without operands (each then also
reads u32 keys and writes u32 keys), torch.sort + 8 torch.gather, and the
calibrate mix on 8 of the rows with the host's time to issue one call.

B7 (exact decode walk) and B9 (parse walk), `--part walks`: where a walk's
time goes, on the inputs chip_smoke.py times them at (B7: the first 8
level-3 text shards, N = 524,288, NS = 131,200; B9: level 6's and level
9's parse blocks and the shards of the level-6 batch), each with its steps
(a row's count of words written or of marks: mean and longest row) and
beside rows of one constant step at the same shapes, whose steps per row
are known: B7 with adv 63 and 16 (the per-step cost is the slope between
them, the intercept what the kernel costs besides the steps: staging,
flushing, zeroing); B9 with a step of n (one step a row: staging and the
mask alone) and of 2 (n / 2 steps a row: the chain; a step of 1 would be
a literal run, which the block walk skips).  ns per step is the walk's
time over the steps of a row; times the real data's longest row it is
what the chain costs there.

    python3 tools/torch_kernel_probe.py --part walks [--tree DIR]

B3 (small-distance runs), `--part runs`: on the inputs chip_smoke.py
times it at (the first 8 MiB batch of the mixed corpus, window, limit and
min_src), once under each level's name (B3 takes the same inputs at every
level: the rows show the spread), then on 64 x 163,840 bytes of the text
corpus, of seeded random bytes and of zeros (every run as long as the
bounds allow), each with the share of groups of 4 positions whose run at
d leaves their 32-position bitmap word (the kernel then reads up to 9
more words) and the share of 4,096-position tiles that hold such a group.
B3 and B6 are timed three ways: by events around --reps calls (as
chip_smoke.py times every kernel), as --reps launches captured in one CUDA
graph and replayed (the device alone), and by the host's time a call;
where the host's time is the larger, the first reads it.

B6 (lane walk), `--part lanes`: at the indexed decode's batch (the first
8 level-3 text shards, as for B7) and on a chained-route row chunk (the
first lane walk of the chained decode of the 8 MiB level-1 mixed member,
64 rows x 2^19 positions), each with its steps, the most marks in one
lane and that lane's chain floor (marks x 20.3 ns); where the measured
tree's kernel takes them, its device split (staging alone, + phase 1, +
the join, against the whole launch) and its device time at 1, 2, 4, 8, 16
and 31 lanes a block.

    python3 tools/torch_kernel_probe.py --part runs,lanes [--tree DIR]

B1 (prep) and B5 (bit pack), `--part prep,pack`: on the level-6 batch.
B1 at level 6's knobs (8 exact words), level 9's (16, and the 3-byte K3
pass's 1) and in fp mode (2 exact + 2 fingerprint words), and the key
sort of its keys at int64 and at int32 (u32 key ^ 2^31, the order the
same), whichever width the measured tree's B1 writes; B5 as the whole
pack_fields call on the level-6 fields (a parent's offsets by torch.cumsum
included), held against its plain version where the tree has one; the
zero-filled buffer it writes into, alone; and, where the tree has it, a
parent's placement alone (`_place`).
Each is timed three ways, as B3 and B6 are.

    python3 tools/torch_kernel_probe.py --part prep,pack [--tree DIR]

The compact field grid, `--part compact` (not in the default parts; no
path of either package packs it): on the fields of the batch at levels
1, 6 and 9, the JAX package's build_fields(compact=True) grid (each row's
live fields first in slot order, then zeros, slot_count_compact columns)
made from the full grid by `compact` (column c takes the row's (c + 1)-th
live field, found by torch.searchsorted on one int32 prefix sum of the
live flag over the whole batch; tests/test_torch_encode2.py holds it to
the JAX grid), held equal to `compact_rows` (a prefix sum a row, the best
of the other designs); the live fields a row against slot_count_compact;
B5 on the compact grid against its plain version, its words and
total_bits those of the full grid.  Timed three ways, as B3 and B6 are:
each compaction, B5 on the compact grid, compaction + B5, and B5 on the
full grid, with the bounds of the compaction (the full grid read, the
compact one written) and of B5 on both grids.

    python3 tools/torch_kernel_probe.py --part compact

End to end, `--part e2e` (not in the default parts): the public entry
points on the host clock, best of 3 (the level-6 encode of 32 MiB mixed,
the indexed decode of the text corpus from levels 1 and 3, the chained
decode of the 8 MiB level-1 mixed member), so that a parent and a change
compare in one call.

S1 (the chunk-entry scanner), `--part scan` (not in the default parts):
on the body of zlib.compress(32 MiB mixed, 6), as chip_smoke.py phase 13,
the public calls scan.chunk_entries at 512 KiB chunks and
scan.scan_headers over the first 8 MiB (max_out 64): each call by CUDA
events over --reps calls (the call fetches its list, so this is the whole
call), the scanner kernel's device time a call by torch.profiler, and the
unindexed decode of that stream through api.zlib.decompress, best of 3 on
the host clock.  The public calls are the same in every tree that has them,
so a parent and a change compare in one call.

    python3 tools/torch_kernel_probe.py --part scan [--tree DIR]

The chained route's rounds, `--part rounds` (not in the default parts):
on the same foreign stream, the first round of its chained decode (the
first block of every chain head: one _decode_round call, by the lane walk
and again by the serial walk, each row with the symbol slots the measured
tree gives it), mean of --reps calls on the host clock (the call fetches
its rows' results, so this is the whole round), then the decode of each
of chip_smoke.py's big-block streams and of phase 16's huffman member of
8 MiB (64 blocks of 131,072 literals) through api.zlib/gzip.decompress,
best of 3 on the host clock.  A tree whose rows start with fewer slots and
walk again with more, and one whose rows hold a slot a bit of their span,
compare in one call.

    python3 tools/torch_kernel_probe.py --part scan,rounds [--tree DIR]

The streaming decode, `--part stream` (not in the default parts): the
Decompressor on chip_smoke.py phase 16's streams, zlib.compress(32 MiB
mixed, 6) at windows of 8 and 2 MiB and the level-6 gzip member of the
same 32 MiB (FLT1) at 8 MiB, read in (1 << 20) + 17-byte pieces, and
zlib.compress(64 MiB of zeros, 6) through zlib.decompress(reader, writer=),
each best of 3 on the host clock with the decoder's peak input and peak
output held (`stats`, the last run's).  The same public calls in every
tree that has the Decompressor, so a parent and a change compare in one
call.

    python3 tools/torch_kernel_probe.py --part stream [--tree DIR]

The fused path, `--part fused` (not in the default parts): the level-1,
-6 and -9 batch (64 x 128 KiB of the mixed corpus, as above) through
pipeline2.encode_batch, one CUDA graph a batch: its capture and
instantiate seconds and node count, one replay's device time (CUDA events
over --reps replays), the eager encode_batch_staged's device time by
events and its host time with a synchronise, and one replay under
torch.profiler: the device time of each of the port's kernels inside it,
the sum over all kernels and the ten largest entries; then the 32 MiB
level-6 encode through compress_device2(fused=False / True), best of 3
on the host clock.

    python3 tools/torch_kernel_probe.py --part fused

The squeeze's cost DP, `--part squeeze` (not in the default parts): on
the level-6 batch at level 6's knobs (parse blocks of 1,024) and level
9's (4,096), from the greedy pass's code lengths: the whole squeeze_parse
call (DP and walk) by events and on the host clock, which a parent's
tree has too; where the tree has the kernel (flate_squeeze_dp), the
kernel alone by events over --reps launches and replayed from a CUDA
graph (the device alone), equal to the plain loop on the same card
tensors (timed once), against its bytes bound (13 bytes a position:
byte, length and distance in, the chosen length out, and the tables) and
its chain floor: blk steps times the ns a step of one lone lane, the
slope between one lane of 4,096 and one of 1,024 positions.

    python3 tools/torch_kernel_probe.py --part squeeze [--tree DIR]

--tree DIR measures the kernels of another checkout (its flate_tpu_torch,
built into DIR/build) with this probe's code, so that a parent and a change
run in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (B, CHAIN_STEP_NS, CTX, HBM_BYTES_PER_S,  # noqa: E402
                        INT_OPS_PER_S, S, chained_chunk, cuda_ms, graph_ms,
                        host_ms, mixed_corpus, most_marks, nbytes, smi,
                        text_corpus)

# the checkout whose flate_tpu_torch is measured: set by main() (--tree)
api = bitonic = encode2 = header = inflate2 = match2 = pack = parse = None
pipeline2 = runs = squeeze = None


def timed(fn, reps: int) -> float:
    fn()
    return cuda_ms(fn, reps)


def three_ways(out: dict, key: str, fn, reps: int) -> str:
    """fn's time by events around reps calls (as chip_smoke.py times it),
    replayed from a CUDA graph (the device alone) and the host's time a
    call, into out[key], out[key + "_graph"], out[key + "_host"]."""
    out[key] = timed(fn, reps)
    out[f"{key}_graph"] = graph_ms(fn, reps)
    out[f"{key}_host"] = host_ms(fn, reps)
    return (f"{out[key]:.4f} ms (graph {out[f'{key}_graph']:.4f}, host "
            f"{out[f'{key}_host']:.4f} a call)")


def level6_batch():
    """The first 8 MiB batch of the mixed corpus, primed with its 32 KiB
    of context as chip_smoke.py primes it: (window, ctx_len, valid), the
    last shard cut to a tail."""
    dev = torch.device("cuda")
    head = mixed_corpus(CTX + B * S)
    ctx0 = torch.frombuffer(bytearray(head[:CTX]), dtype=torch.uint8).to(dev)
    shards = torch.frombuffer(bytearray(head[CTX:]), dtype=torch.uint8
                              ).reshape(B, S).to(dev)
    window = pipeline2._prime_windows(shards, ctx0, CTX)
    ctx_len = torch.full((B,), CTX, dtype=torch.int32, device=dev)
    valid = torch.full((B,), S, dtype=torch.int32, device=dev)
    valid[-1] = S - 12345
    return window, ctx_len, valid


def matcher(reps: int) -> dict:
    window, ctx_len, valid = level6_batch()
    W = window.shape[1]
    min_src = (CTX - ctx_len).to(torch.int32)
    limit = (CTX + valid).to(torch.int32)
    out = {}
    for ne, Ks in ((8, (0, 1, 4, 16, 48)), (1, (48,)), (2, (48,)),
                   (3, (48,)), (6, (48,)), (16, (160,))):
        key, fps = match2._prep(window, ne, 4)
        skey, order = torch.sort(key, dim=1)
        for K in Ks:
            ms = timed(lambda: match2._run_matcher(
                skey, order, window, fps, min_src, limit, W, K, 32768, ne),
                reps)
            out[f"matcher_ne{ne}_K{K}"] = ms
            print(f"B2 ne={ne} K={K}: {ms:.4f} ms", flush=True)
    ne, nf = match2._split_words(8, True)
    key, fps = match2._prep(window, ne, 4, nf)
    skey, order = torch.sort(key, dim=1)
    ms = timed(lambda: match2._run_matcher(
        skey, order, window, fps, min_src, limit, W, 48, 32768, ne,
        top2=True), reps)
    out["matcher_fp_K48"] = ms
    print(f"B2 fp/top-2 ne={ne} nf={nf} K=48: {ms:.4f} ms", flush=True)
    return out


def network(reps: int) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = bitonic.R * bitonic.C
    shape = (64, bitonic.R, bitonic.C)
    k = rng.integers(0, 2**32, shape, dtype=np.uint32)
    key = torch.from_numpy(k).to(dev)
    ops = [torch.from_numpy(k + np.uint32(i)).to(dev) for i in range(8)]
    full = bitonic.bitonic_stages(n)
    out = {}

    def one(name, o, stages):
        ms = timed(lambda: bitonic.run(key, o, stages), reps)
        out[name] = ms
        print(f"B10 {name}: {ms:.4f} ms", flush=True)

    one("full_8_operands", ops, full)
    one("full_no_operand", [], full)
    one("empty_list_8_operands", ops, ())
    for i, (kind, run) in enumerate(bitonic.plan_passes(full, n)):
        one(f"pass{i}_{kind}_{len(run)}_no_operand", [], run)
    k64 = key.reshape(64, n).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    o32 = [o.reshape(64, n).view(torch.int32) for o in ops]

    def library():
        s, idx = torch.sort(k64, dim=1)
        return (s, *[torch.gather(o, 1, idx) for o in o32])

    out["library_sort_gather"] = timed(library, reps)
    print(f"B10 torch.sort + 8 gathers: {out['library_sort_gather']:.4f} ms",
          flush=True)
    # the calibrate mix on 8 rows, as chip_smoke.py times it, beside the
    # host's time to issue one call (the card waits on the host above it)
    k8, o8 = key[:8].contiguous(), [o[:8].contiguous() for o in ops]

    def mix():
        return bitonic.run(k8, o8, bitonic.CALIBRATE_MIX)

    out["mix_8_rows"] = timed(mix, reps)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        mix()
    out["mix_8_rows_host_ms_a_call"] = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    print(f"B10 calibrate mix, 8 rows: {out['mix_8_rows']:.4f} ms; host "
          f"{out['mix_8_rows_host_ms_a_call']:.4f} ms a call", flush=True)
    return out


def block_hops(step: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Steps per row the block walk's walker takes: the marked positions
    but the literals (next position p + 1) that follow a marked literal in
    their group of 8, which the walker jumps over."""
    n = step.shape[1]
    pos = torch.arange(n, device=step.device)
    lit = torch.clamp(pos + torch.clamp(step, min=1), max=n) == pos + 1
    prev = torch.nn.functional.pad(mask & lit, (1, 0))[:, :n]
    return (mask & ~(prev & lit & (pos % 8 != 0))).sum(dim=1)


def text_words():
    """(word, start, nbits) of the first 8 level-3 text shards, the decode
    batch chip_smoke.py phase 5 times B6 and B7 on."""
    from flate_tpu_torch.containers import Container, parse_header
    from flate_tpu_torch.shard_index import parse_index_extra
    blob = api.gzip.compress(text_corpus(3_359_630), level=3)
    hdr, meta = parse_header(Container.GZIP, blob)
    comp_lens, out_lens, _ = parse_index_extra(meta.extra)
    run, off = [], hdr
    for c_len, o_len in zip(comp_lens[:8], out_lens[:8]):
        sh = blob[off:off + int(c_len)]
        off += int(c_len)
        run.append((inflate2.plan_shard(sh, int(o_len)), sh))
    dargs = inflate2.pack_coded_run(run, b"", torch.device("cuda"))
    word = inflate2._pass1(dargs[0], *dargs[3:9])
    return word, dargs[2], 8 * dargs[1]


def walks(reps: int) -> dict:
    dev = torch.device("cuda")
    out = {}

    def row_steps(name, counts):
        out[f"{name}_steps_mean"] = float(counts.float().mean())
        out[f"{name}_steps_max"] = int(counts.max())
        out[f"{name}_steps_total"] = int(counts.sum())

    def one(name, fn, r=reps):
        out[name] = timed(fn, r)
        print(f"{name}: {out[name]:.4f} ms", flush=True)

    # B7 on the first 8 level-3 text shards, as chip_smoke.py phase 5
    word, start, nbits = text_words()
    DB, DN = word.shape
    NS = S + 128
    _, counts = inflate2._walk(word, start, nbits, NS)
    row_steps("B7_text", counts)
    one("B7_text", lambda: inflate2._walk(word, start, nbits, NS))
    one("B7_empty", lambda: inflate2._walk(word, nbits, nbits, NS))
    fit = {}
    for A in (63, 16):
        syn = torch.full((DB, DN), A, dtype=torch.int32, device=dev)
        full = torch.full((DB,), DN, dtype=torch.int32, device=dev)
        zero = torch.zeros(DB, dtype=torch.int32, device=dev)
        ns_a = DN // A + 128
        steps = int(inflate2._walk(syn, zero, full, ns_a)[1].max())
        one(f"B7_adv{A}", lambda: inflate2._walk(syn, zero, full, ns_a))
        out[f"B7_adv{A}_steps"] = steps
        fit[A] = (steps, out[f"B7_adv{A}"])
        del syn
    (s1, t1), (s2, t2) = fit[63], fit[16]
    slope = (t2 - t1) / (s2 - s1)
    out["B7_ns_per_step"] = slope * 1e6
    out["B7_intercept_ms"] = t1 - slope * s1
    out["B7_text_walk_ms"] = slope * out["B7_text_steps_max"]
    print(f"B7: {out['B7_ns_per_step']:.3f} ns a step (slope), "
          f"{out['B7_intercept_ms']:.4f} ms besides the steps; text: "
          f"{out['B7_text_steps_max']} steps in the longest row -> walk "
          f"{out['B7_text_walk_ms']:.4f} ms of {out['B7_text']:.4f}",
          flush=True)
    del word

    # B9 on the level-6 batch: parse blocks at levels 6 and 9, shards
    window, ctx_len, valid = level6_batch()
    for L in (6, 9):
        lvl = pipeline2.level_params(L, S)
        ml, md = match2.find_matches_fused(window, ctx_len, valid, K=lvl["K"],
                                           nw=lvl["nw"], ctx=CTX,
                                           K3=lvl["K3"])
        shapes = {f"B9_blocks_l{L}": lvl["blk"]}
        if L == 6:
            shapes["B9_shards"] = S
        for name, n in shapes.items():
            if n == S:                   # parse_walk: untruncated matches
                _, step = parse.decide(ml, md, True, 32)
            else:
                tl, td = parse.truncate_matches(ml, md, CTX, n)
                _, step = parse.decide(tl, td, lvl["lazy"], lvl["max_lazy"])
            step = step[:, CTX:].to(torch.int32).reshape(-1, n).contiguous()
            R = step.shape[0]
            mask = parse._parse_walk(step)
            row_steps(name, mask.sum(dim=1))
            if n < S:
                row_steps(f"{name}_hops", block_hops(step, mask))
            one(name, lambda: parse._parse_walk(step))
            for A, tag in ((n, "one_step"), (2, "step2")):
                syn = torch.full((R, n), A, dtype=torch.int32, device=dev)
                one(f"{name}_{tag}", lambda: parse._parse_walk(syn),
                    r=min(reps, 5) if A == 2 and n == S else reps)
            per = (out[f"{name}_step2"] - out[f"{name}_one_step"]) / (n // 2 - 1)
            out[f"{name}_ns_per_step"] = per * 1e6
            out[f"{name}_walk_ms"] = per * out[f"{name}_steps_max"]
            hops = (f" (hops of the walker, literal runs skipped within 8 "
                    f"positions: mean {out[f'{name}_hops_steps_mean']:.1f} "
                    f"longest {out[f'{name}_hops_steps_max']})"
                    if n < S else "")
            print(f"{name}: {R} rows x {n}, steps mean "
                  f"{out[f'{name}_steps_mean']:.1f} longest "
                  f"{out[f'{name}_steps_max']}{hops}; one step a row (staging and "
                  f"the mask) {out[f'{name}_one_step']:.4f} ms; "
                  f"{out[f'{name}_ns_per_step']:.3f} ns a step of a row of "
                  f"steps of 2 -> longest row's walk "
                  f"{out[f'{name}_walk_ms']:.4f} ms of {out[name]:.4f}",
                  flush=True)
    return out


def leave_shares(win: torch.Tensor, limit: torch.Tensor) -> dict:
    """Per d, the share of groups of 4 positions whose run leaves their
    32-position stop word (no mismatch and not past min(W, limit) at or
    after the group's last position in the word), and the share of
    4,096-position tiles with such a group at any d."""
    Bw, W = win.shape
    Wp = -(-W // 4096) * 4096
    w = win.to(torch.int16)
    pos = torch.arange(Wp, device=win.device)[None, :]
    end = torch.clamp(limit.to(torch.int64), max=W)[:, None]
    idx = torch.arange(32, device=win.device)
    g_last = torch.arange(8, device=win.device) * 4 + 3
    out, leave_any = {}, None
    for d in (1, 2, 3, 4, 8):
        prev = torch.nn.functional.pad(w[:, :W - d], (d, 0))
        stop = torch.nn.functional.pad(w != prev, (0, Wp - W), value=True)
        stop = (stop | (pos >= end)).reshape(Bw, Wp // 32, 32)
        last = torch.where(stop, idx, -1).amax(dim=2)
        leave = last[..., None] < g_last            # (B, words, 8 groups)
        out[f"d{d}"] = float(leave.float().mean())
        leave_any = leave if leave_any is None else leave_any | leave
    out["tiles"] = float(leave_any.reshape(Bw, Wp // 4096, -1).any(dim=2)
                         .float().mean())
    return out


def small_runs(reps: int) -> dict:
    window, ctx_len, valid = level6_batch()
    Bw, W = window.shape
    dev = window.device
    min_src = (CTX - ctx_len).to(torch.int32)
    limit = (CTX + valid).to(torch.int32)
    out = {}
    for L in (1, 3, 6, 9):
        line = three_ways(out, f"B3_l{L}", lambda: runs.small_dist_runs(
            window, limit, min_src), reps)
        print(f"B3 at level {L}'s inputs: {line}", flush=True)
    rng = np.random.default_rng(0)
    corpora = {
        "mixed": window,
        "text": torch.frombuffer(bytearray(text_corpus(Bw * W)),
                                 dtype=torch.uint8).reshape(Bw, W).to(dev),
        "random": torch.from_numpy(rng.integers(0, 256, (Bw, W),
                                                dtype=np.uint8)).to(dev),
        "zeros": torch.zeros_like(window)}
    for name, win in corpora.items():
        line = three_ways(out, f"B3_{name}", lambda: runs.small_dist_runs(
            win, limit, min_src), reps)
        share = leave_shares(win, limit)
        out[f"B3_{name}_leave_share"] = share
        print(f"B3 on {name}: {line}; groups of 4 that leave their "
              f"word by d " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        share.items() if k != "tiles")
              + f"; tiles with such a group {share['tiles']:.4f}",
              flush=True)
    return out


def lanes(reps: int) -> dict:
    G, J = inflate2.LANE_G, inflate2.LANE_J
    out = {}
    chunks = {"table": text_words(),
              "chained": chained_chunk(api, inflate2, api.gzip.compress(
                  mixed_corpus(B * S), level=1))}
    split = hasattr(inflate2, "_lane_walk_cuda")
    for name, (word, start, nbits) in chunks.items():
        steps = {}
        mask = inflate2._lane_walk_plain(word, start, nbits, G, J, steps)[0]
        marks = most_marks(mask, G)
        key = f"B6_{name}"
        times = three_ways(out, key, lambda: inflate2._lane_walk(
            word, start, nbits, G=G, J=J), reps)
        out[f"{key}_steps"] = steps
        out[f"{key}_most_marks"] = marks
        out[f"{key}_chain_floor_ms"] = marks * CHAIN_STEP_NS * 1e-6
        line = (f"B6 {name}: {tuple(word.shape)}, {times}; steps {steps}; "
                f"most marks in one lane {marks} -> chain floor "
                f"{out[f'{key}_chain_floor_ms']:.4f} ms")
        if split:                    # device times, from CUDA graphs
            for ph, what in ((0, "staging"), (1, "phase1"), (2, "join")):
                out[f"{key}_upto_{what}_graph"] = graph_ms(
                    lambda: inflate2._lane_walk_cuda(word, start, nbits, G, J,
                                                     phases=ph), reps)
            st, p1, jn = (out[f"{key}_upto_{w}_graph"]
                          for w in ("staging", "phase1", "join"))
            line += (f"; device split: staging {st:.4f}, phase 1 "
                     f"{p1 - st:.4f}, join {jn - p1:.4f}, write-out "
                     f"{out[f'{key}_graph'] - jn:.4f} ms")
            for L in (1, 2, 4, 8, 16, 31):
                out[f"{key}_L{L}_graph"] = graph_ms(
                    lambda: inflate2._lane_walk_cuda(word, start, nbits, G, J,
                                                     L=L), reps)
            line += "; device ms by lanes a block " + ", ".join(
                f"{L}: {out[f'{key}_L{L}_graph']:.4f}"
                for L in (1, 2, 4, 8, 16, 31))
        print(line, flush=True)
    return out


def prep(reps: int) -> dict:
    window, _, _ = level6_batch()
    out = {}
    for name, ne, hb, nf in (("l6", 8, 4, 0), ("l9", 16, 4, 0),
                             ("k3", 1, 3, 0), ("fp", 2, 4, 2)):
        line = three_ways(out, f"B1_{name}", lambda: match2._prep(
            window, ne, hb, nf), reps)
        print(f"B1 {name} (ne={ne}, hash_bytes={hb}, nf={nf}): {line}",
              flush=True)
    key = match2._prep(window, 8, 4)[0]
    out["B1_key_dtype"] = str(key.dtype)
    # the same u32 keys at both widths, whatever this tree's B1 writes
    k64 = key.to(torch.int64) & 0xFFFFFFFF
    if key.dtype == torch.int32:
        k64 = k64 ^ 0x80000000
    k32 = k64 ^ 0x80000000
    k32 = torch.where(k32 >= 1 << 31, k32 - (1 << 32), k32).to(torch.int32)
    if not torch.equal(torch.sort(k32, dim=1)[1][:, :window.shape[1]],
                       torch.sort(k64, dim=1)[1][:, :window.shape[1]]):
        raise AssertionError("int32 and int64 key sorts differ")
    for width, k in (("int64", k64), ("int32", k32)):
        line = three_ways(out, f"sort_{width}", lambda: torch.sort(k, dim=1),
                          reps)
        print(f"key sort at {width}: {line}", flush=True)
    line = three_ways(out, "sort_tree_keys", lambda: torch.sort(key, dim=1),
                      reps)
    print(f"key sort of this tree's B1 keys ({key.dtype}): {line}",
          flush=True)
    return out


def sm_clock() -> str:
    """The card's SM clock now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def squeeze_part(reps: int) -> dict:
    out = {}
    window, ctx_len, valid = level6_batch()
    kernel = getattr(squeeze, "_squeeze_dp_kernel", None)
    lone = {}
    for L in (6, 9):
        lvl = pipeline2.level_params(L, S)
        blk = lvl["blk"]
        ml, md = match2.find_matches_fused(window, ctx_len, valid, K=lvl["K"],
                                           nw=lvl["nw"], ctx=CTX,
                                           K3=lvl["K3"])
        ml, md = parse.truncate_matches(ml, md, CTX, blk)
        take, _ = parse.decide(ml, md, lvl["lazy"], lvl["max_lazy"])
        starts = parse.parse_blocks(ml, md, start=CTX, lazy=lvl["lazy"],
                                    max_lazy=lvl["max_lazy"], blk=blk)
        wt, m_r, d_r = window[:, CTX:], ml[:, CTX:], md[:, CTX:]
        ll, dd = squeeze.greedy_code_lengths(wt, m_r, d_r, starts[:, CTX:],
                                             take[:, CTX:], valid)
        tag = f"squeeze_l{L}"
        line = three_ways(out, f"{tag}_parse", lambda: squeeze.squeeze_parse(
            wt, m_r, d_r, ll, dd, blk=blk), reps)
        print(f"{tag}: squeeze_parse (DP and walk), blk {blk}: {line}",
              flush=True)
        if kernel is None:
            continue
        args = (wt, m_r, d_r, ll, dd, blk, False)
        got = kernel(*args)
        t0 = time.perf_counter()        # the clocks up before the lone lanes
        while time.perf_counter() - t0 < 0.5:
            kernel(*args)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = squeeze._squeeze_dp_plain(*args)
        torch.cuda.synchronize()
        out[f"{tag}_plain_ms"] = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: flate_squeeze_dp != the plain loop "
                                 f"({int((got != want).sum())} positions)")
        line = three_ways(out, f"{tag}_dp", lambda: kernel(*args), reps)
        moved = nbytes(wt, m_r, d_r, got, ll, dd)
        out[f"{tag}_dp_bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
        for n in sorted({1024, 4096, blk}):   # one lane of n positions
            if n not in lone:
                one = (wt[:1, :n], m_r[:1, :n], d_r[:1, :n], ll[:1], dd[:1],
                       n, False)
                lone[n] = timed(lambda: kernel(*one), reps)
        ns_step = (lone[4096] - lone[1024]) / 3072 * 1e6
        out[f"{tag}_dp_ns_per_step"] = ns_step
        out[f"{tag}_dp_chain_floor_ms"] = blk * ns_step * 1e-6
        out[f"{tag}_sm_clock"] = sm_clock()
        print(f"{tag}: flate_squeeze_dp equal to the plain loop (plain "
              f"{out[f'{tag}_plain_ms']:.4f} ms), {line}; bound "
              f"{out[f'{tag}_dp_bound_ms']:.4f} ms by bytes ({moved} B); "
              f"one lane {lone[1024]:.4f} ms at 1,024, {lone[4096]:.4f} at "
              f"4,096 -> {ns_step:.3f} ns a step, chain floor "
              f"{out[f'{tag}_dp_chain_floor_ms']:.4f} ms; SM clock after "
              f"{out[f'{tag}_sm_clock']}", flush=True)
    return out


def batch_fields(level: int = 6):
    """build_fields' (vals, bits) of the batch at a level's knobs and its
    segment size, through the measured tree's stages as
    encode_batch_packed runs them."""
    window, ctx_len, valid = level6_batch()
    lvl = pipeline2.level_params(level, S)
    blk = lvl["blk"]
    ml, md = match2.find_matches_fused(window, ctx_len, valid, K=lvl["K"],
                                       nw=lvl["nw"], ctx=CTX, K3=lvl["K3"])
    ml, md = parse.truncate_matches(ml, md, CTX, blk)
    take, _ = parse.decide(ml, md, lvl["lazy"], lvl["max_lazy"])
    starts = parse.parse_blocks(ml, md, start=CTX, lazy=lvl["lazy"],
                                max_lazy=lvl["max_lazy"], blk=blk)
    m_r, d_r = ml[:, CTX:], md[:, CTX:]
    take_r, starts_r = take[:, CTX:], starts[:, CTX:]
    if lvl["squeeze"]:
        take_r, starts_r, m_r = pipeline2._squeeze_stage(
            window[:, CTX:], m_r, d_r, take_r, starts_r, valid, blk=blk)
    seg = encode2.seg_size(S, blk)
    finals = torch.zeros(B, dtype=torch.int32, device=window.device)
    vals, bits, _, _ = encode2.build_fields(
        window[:, CTX:], m_r, d_r, starts_r, take_r, valid, finals, S, seg)
    return vals, bits, seg


def pack_part(reps: int) -> dict:
    vals, bits, seg = batch_fields()
    nwr = pipeline2._nwr(S, seg)
    out = {"B5_vals_dtype": str(vals.dtype),
           "B5_live_fields": int((bits != 0).sum())}
    if hasattr(pack, "_pack_plain"):     # the kernel against its plain version
        got = pack.pack_fields(vals, bits, nwr)
        want = pack._pack_plain(vals, bits, nwr * 128)
        if not (torch.equal(got[0].reshape(B, -1), want[0])
                and torch.equal(got[1], want[1])):
            raise AssertionError("B5: pack_fields != its plain version")
    line = three_ways(out, "B5_pack_fields", lambda: pack.pack_fields(
        vals, bits, nwr), reps)
    print(f"B5 pack_fields at level 6 ({tuple(vals.shape)} fields, "
          f"{out['B5_live_fields']} live, values {vals.dtype}): {line}",
          flush=True)
    if hasattr(pack, "PACK_TILE"):       # the zeroed buffer B5 writes into
        n = B * nwr * 128 + 2 * B * -(-vals.shape[1] // pack.PACK_TILE) + 2 + B
        line = three_ways(out, "B5_zero_fill", lambda: torch.zeros(
            n, dtype=torch.int32, device=vals.device), reps)
        print(f"B5's zero-filled buffer alone ({4 * n} bytes): {line}",
              flush=True)
    if hasattr(pack, "_place"):          # a parent: the placement alone
        b32 = bits.to(torch.int32)
        incl = torch.cumsum(b32, dim=1, dtype=torch.int32)
        off = (incl - b32).contiguous()
        v64 = vals.to(torch.int64).contiguous()
        line = three_ways(out, "B5_place", lambda: pack._place(
            v64, off, nwr * 128), reps)
        print(f"B5 placement alone (_place: zeros and the kernel): {line}",
              flush=True)
    return out


def slot_count_compact(S: int, seg: int, hdr_slots: int) -> int:
    """The compact grid's width, as jx/encode2.py:92-102 gives it: at most
    one live body field a position (a token start emits fa; fb is live
    only for matches, which take >= 3 positions each), plus <= 4 boundary
    fields a segment and the trailer's 4, and one full header
    (hdr_slots) a block opening (an opening follows a segment that is not
    coded, so at most every other segment opens one), padded to 512."""
    ns = -(-S // seg)
    raw = S + 4 + ns * 4 + (ns // 2 + 1) * hdr_slots
    return -(-raw // 512) * 512


def compact(vals: torch.Tensor, bits: torch.Tensor, width: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The live fields (bits > 0) first, in slot order, then zero fields,
    cut to `width` columns: what the JAX package's stable sort on the live
    flag gives.  Column c of a row takes the row's (c + 1)-th live field,
    found by a binary search of one prefix sum of the live flag over the
    whole batch (a prefix sum a row runs on too few rows to fill the
    card)."""
    B_, slots = bits.shape
    dt = torch.int32 if bits.numel() < 2**31 else torch.int64
    cum = torch.cumsum((bits > 0).reshape(-1), 0, dtype=dt).view(B_, slots)
    before = torch.cat([cum.new_zeros(1), cum[:-1, -1]])[:, None]
    want = before + torch.arange(1, width + 1, dtype=dt, device=bits.device)
    src = torch.clamp(torch.searchsorted(cum, want), max=slots - 1)
    keep = want <= cum[:, -1:]
    return (torch.where(keep, torch.gather(vals, 1, src), 0),
            torch.where(keep, torch.gather(bits, 1, src), 0))


def compact_rows(vals, bits, width):
    """compact's gather with a prefix sum a row."""
    B_, slots = bits.shape
    cum = torch.cumsum(bits > 0, dim=1, dtype=torch.int32)
    want = torch.arange(1, width + 1, dtype=torch.int32,
                        device=bits.device).expand(B_, width).contiguous()
    src = torch.clamp(torch.searchsorted(cum, want), max=slots - 1)
    keep = want <= cum[:, -1:]
    return (torch.where(keep, torch.gather(vals, 1, src), 0),
            torch.where(keep, torch.gather(bits, 1, src), 0))


def compact_part(reps: int) -> dict:
    out = {}
    for L in (1, 6, 9):
        vals, bits, seg = batch_fields(L)
        nwr = pipeline2._nwr(S, seg)
        SC = slot_count_compact(S, seg, header.HDR_SLOTS)
        nlive = (bits > 0).sum(dim=1).cpu().numpy()
        if nlive.max() > SC:
            raise AssertionError(f"level {L}: {nlive.max()} live fields in "
                                 f"a row, over slot_count_compact {SC}")
        vc, bc = compact(vals, bits, SC)
        if not all(torch.equal(a, b) for a, b in
                   zip(compact_rows(vals, bits, SC), (vc, bc))):
            raise AssertionError(f"level {L}: compact_rows != compact")
        cw, ct = pack.pack_fields(vc, bc, nwr)
        pw, pt = pack._pack_plain(vc, bc, nwr * 128)
        if not (torch.equal(cw.reshape(B, -1), pw) and torch.equal(ct, pt)):
            raise AssertionError(f"level {L}: B5 on the compact grid != its "
                                 f"plain version")
        fw, ft = pack.pack_fields(vals, bits, nwr)
        if not (torch.equal(cw, fw) and torch.equal(ct, ft)):
            raise AssertionError(f"level {L}: the compact grid packs to "
                                 f"other words or total_bits")
        k = f"l{L}_"
        out.update({k + "slots": bits.shape[1], k + "compact_slots": SC,
                    k + "live_min": int(nlive.min()),
                    k + "live_max": int(nlive.max()),
                    k + "live_mean": float(nlive.mean())})
        grid_in = nbytes(vals, bits)
        out[k + "compact_bound"] = ((grid_in + 8 * B * SC)
                                    / HBM_BYTES_PER_S * 1e3)
        out[k + "B5_compact_bound"] = max(
            (nbytes(vc, bc) + B * nwr * 128 * 4) / HBM_BYTES_PER_S,
            3 * int(nlive.sum()) / INT_OPS_PER_S) * 1e3
        out[k + "B5_full_bound"] = max(
            (grid_in + B * nwr * 128 * 4) / HBM_BYTES_PER_S,
            3 * int(nlive.sum()) / INT_OPS_PER_S) * 1e3
        print(f"level {L}: live fields a row {nlive.min()}-{nlive.max()} "
              f"(mean {nlive.mean():.1f}) of slot_count_compact {SC} "
              f"(slot_count {bits.shape[1]}); compact == compact_rows; B5 "
              f"on it == its plain version and the full grid's words and "
              f"total_bits; bounds: "
              f"compaction {out[k + 'compact_bound']:.4f} ms, B5 compact "
              f"{out[k + 'B5_compact_bound']:.4f}, B5 full "
              f"{out[k + 'B5_full_bound']:.4f}", flush=True)
        for name, fn in (
                ("compact", lambda: compact(vals, bits, SC)),
                ("compact_rows", lambda: compact_rows(vals, bits, SC)),
                ("B5_compact", lambda: pack.pack_fields(vc, bc, nwr)),
                ("compact_and_B5", lambda: pack.pack_fields(
                    *compact(vals, bits, SC), nwr)),
                ("B5_full", lambda: pack.pack_fields(vals, bits, nwr))):
            line = three_ways(out, k + name, fn, reps)
            print(f"level {L} {name}: {line}", flush=True)
    return out


def e2e(reps: int) -> dict:
    """The public entry points on the host clock, as chip_smoke.py phases
    4, 6 and 8 time them, best of 3 after a warm-up: the 32 MiB mixed
    corpus encoded at level 6, the text corpus decoded from levels 1 and 3
    (indexed route) and the 8 MiB level-1 mixed member (chained route)."""
    data32 = mixed_corpus(4 * B * S)
    text = text_corpus(3_359_630)
    mixed1 = api.gzip.compress(data32[:B * S], level=1)
    calls = {"encode_l6_mixed32": (len(data32),
                                   lambda: api.gzip.compress(data32, level=6))}
    for L in (1, 3):
        blob = api.gzip.compress(text, level=L)
        calls[f"decode_text_l{L}"] = (len(text),
                                      lambda b=blob: api.gzip.decompress(b))
    calls["decode_mixed8_l1_chained"] = (
        B * S, lambda: api.gzip.decompress(mixed1))
    out = {}
    for name, (size, fn) in calls.items():
        fn()
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        out[f"{name}_gbps"] = size / best / 1e9
        print(f"{name}: best of 3 {best:.4f} s = "
              f"{out[f'{name}_gbps']:.4f} GB/s", flush=True)
    return out


def scan_part(reps: int) -> dict:
    """S1 on phase 13's foreign body: the whole public calls, the kernel's
    device time inside them, and the foreign decode (best of 3)."""
    import zlib
    from flate_tpu_torch.device import scan
    data32 = mixed_corpus(4 * B * S)
    foreign = zlib.compress(data32, 6)
    sbuf = torch.frombuffer(bytearray(foreign[2:]), dtype=torch.uint8
                            ).to("cuda")
    calls = {"scan_chunk_entries": lambda: scan.chunk_entries(sbuf, 1 << 19),
             "scan_headers_8mib": lambda: scan.scan_headers(
                 sbuf, 0, 8 * (8 << 20), 64)}
    out = {}
    for name, fn in calls.items():
        out[f"{name}_call"] = timed(fn, reps)
        prof = replay_profile(lambda: [fn() for _ in range(reps)])
        kernel = sum(t for k, t in prof.items() if "scan_kernel" in k)
        out[f"{name}_kernel"] = kernel / reps
        print(f"{name}: whole call {out[f'{name}_call']:.4f} ms (events "
              f"over {reps}), scan_kernel {out[f'{name}_kernel']:.4f} ms a "
              f"call (torch.profiler); {len(fn())} offsets", flush=True)
    api.zlib.decompress(foreign)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = api.zlib.decompress(foreign)
        best = min(best, time.perf_counter() - t)
    if got != data32:
        raise AssertionError("foreign decode differs from its input")
    out["decode_foreign_gbps"] = len(data32) / best / 1e9
    print(f"decode_foreign: best of 3 {best:.4f} s = "
          f"{out['decode_foreign_gbps']:.4f} GB/s", flush=True)
    return out


def rounds_part(reps: int) -> dict:
    """The chained route's first round on the foreign stream, by the lane
    walk and by the serial walk, and the big-block and huffman streams'
    decodes."""
    import inspect
    import zlib

    from chip_smoke import big_block_streams
    from flate_tpu_torch.device import anyinflate, scan
    dev = torch.device("cuda")
    body = zlib.compress(mixed_corpus(4 * B * S), 6)[2:]
    heads = scan.chunk_entries(body, anyinflate.CHUNK_BYTES, device=dev)
    plans = [anyinflate.plan_block_at(body, e) for e in heads]
    # a tree with per-block symbol slots takes them as a fourth argument
    slots = ({},) if "slots" in inspect.signature(
        anyinflate._decode_round).parameters else ()
    out = {}
    for walk, serial_set in (("lane", set()), ("serial", set(heads))):
        def once():
            return anyinflate._decode_round(body, plans, {}, *slots,
                                            serial_set, dev)
        # rows whose lanes did not join: the decode walks them again
        unjoined = sum(not r["ok"] for r in once().values())
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            once()
        key = f"round1_{walk}_ms"
        out[key] = (time.perf_counter() - t) / reps * 1e3
        print(f"first round of the foreign decode, {walk} walk: "
              f"{len(plans)} blocks ({unjoined} not joined), "
              f"{out[key]:.4f} ms a round (mean of {reps}, host clock)",
              flush=True)
    for name, container, blob, want in big_block_streams():
        ns = getattr(api, container.lower())
        ns.decompress(blob)
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = ns.decompress(blob)
            best = min(best, time.perf_counter() - t)
        if got != want:
            raise AssertionError(f"{name}: output differs from its input")
        out[f"decode_{name}_s"] = best
        print(f"decode {name}: best of 3 {best:.4f} s = "
              f"{len(want) / best / 1e9:.4f} GB/s", flush=True)
    # chip_smoke.py phase 16's huffman member: 64 blocks of 131,072
    # literals, each past its first 64 KiB span
    data8 = mixed_corpus(B * S)
    blob = api.gzip.huffman.compress(data8)
    api.gzip.decompress(blob)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = api.gzip.decompress(blob)
        best = min(best, time.perf_counter() - t)
    if got != data8:
        raise AssertionError("huffman 8 MiB: output differs from its input")
    out["decode_huffman_8mib_s"] = best
    print(f"decode huffman_8mib: best of 3 {best:.4f} s = "
          f"{len(data8) / best / 1e9:.4f} GB/s", flush=True)
    return out


PORT_KERNELS = ("prep_kernel", "matcher_kernel", "small_runs_kernel",
                "extend_kernel", "parse_rows_kernel", "parse_ring_kernel",
                "pack_kernel")


def replay_profile(replay) -> dict:
    """Device time (ms) by kernel name of one replay, from torch.profiler
    (empty when the profiler sees no kernel inside a graph)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


def fused(reps: int) -> dict:
    from flate_tpu_torch.device import graphs
    window, ctx_len, valid = level6_batch()
    dev = window.device
    shards = window[:, CTX:].contiguous()
    ctx0 = window[0, :CTX].contiguous()
    finals = torch.zeros(B, dtype=torch.int32, device=dev)
    finals[-1] = 1
    args = (shards, ctx0, ctx_len, valid, finals)
    out = {}
    for L in (1, 6, 9):
        kn = dict(S=S, ctx=CTX, **pipeline2.level_params(L, S))
        graphs.clear()
        pipeline2.encode_batch(*args, **kn)
        (g,) = graphs._GRAPHS.values()
        replay = g.graph.replay
        out[f"l{L}_capture_s"] = g.capture_s
        out[f"l{L}_instantiate_s"] = g.instantiate_s
        out[f"l{L}_nodes"] = g.nodes
        out[f"l{L}_replay_ms"] = timed(replay, reps)
        staged = lambda: pipeline2.encode_batch_staged(*args, **kn)  # noqa
        out[f"l{L}_staged_ms"] = timed(staged, 3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        staged()
        torch.cuda.synchronize()
        out[f"l{L}_staged_host_ms"] = (time.perf_counter() - t) * 1e3
        prof = replay_profile(replay)
        ours = {k: sum(v for name, v in prof.items() if k in name)
                for k in PORT_KERNELS}
        out[f"l{L}_kernels_ms"] = ours
        out[f"l{L}_profiled_ms"] = sum(prof.values())
        top = [(k[:60], round(v, 3))
               for k, v in sorted(prof.items(), key=lambda kv: -kv[1])[:10]]
        mine = {k: round(v, 4) for k, v in ours.items()}
        print(f"level {L}: graph capture {g.capture_s:.3f} s, instantiate "
              f"{g.instantiate_s} s, {g.nodes} nodes; one replay "
              f"{out[f'l{L}_replay_ms']:.3f} ms of device time; staged "
              f"batch {out[f'l{L}_staged_ms']:.3f} ms by events, "
              f"{out[f'l{L}_staged_host_ms']:.3f} ms on the host clock; "
              f"profiled replay: {out[f'l{L}_profiled_ms']:.3f} ms in "
              f"kernels, the port's {mine}; largest {top}", flush=True)
    graphs.clear()
    data32 = mixed_corpus(4 * B * S)
    for flag in (False, True, True, False):
        fn = lambda: pipeline2.compress_device2(data32, level=6,  # noqa
                                                fused=flag)
        fn()
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        key = f"encode_l6_mixed32_{'fused' if flag else 'staged'}_s"
        out.setdefault(key, []).append(best)
        print(f"32 MiB level 6, fused={flag}: best of 3 {best:.4f} s = "
              f"{len(data32) / best / 1e9:.4f} GB/s", flush=True)
    return out


def stream_part(reps: int) -> dict:
    """The streaming Decompressor's seconds and peak memory on phase 16's
    streams and on 64 MiB of zeros (best of 3)."""
    import io
    import zlib

    from chip_smoke import ChunkReader, CheckWriter
    data32 = mixed_corpus(4 * B * S)
    foreign = zlib.compress(data32, 6)
    member6 = api.gzip.compress(data32, level=6)
    zeros = zlib.compress(bytes(64 << 20), 6)
    zcrc = zlib.crc32(bytes(64 << 20))
    window = api.Decompressor.WINDOW

    def read(container, blob, w):
        def run():
            d = getattr(api, container).decompressor(io.BytesIO(blob))
            d.WINDOW = w
            n = 0
            while chunk := d.read((1 << 20) + 17):
                n += len(chunk)
            if n != len(data32):
                raise AssertionError(f"{container} stream: {n} bytes")
            return d.stats
        return run

    def writer():
        w = CheckWriter()
        d = api.zlib.decompressor(ChunkReader(zeros, 1 << 17))
        d.decompress(w)
        if (w.n, w.crc) != (64 << 20, zcrc):
            raise AssertionError("zeros: wrong bytes")
        return d.stats

    calls = {"foreign_8mib": read("zlib", foreign, window),
             "foreign_2mib": read("zlib", foreign, window // 4),
             "flt1_8mib": read("gzip", member6, window),
             "zeros_64mib_writer": writer}
    out = {}
    for name, fn in calls.items():
        fn()
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            stats = fn()
            best = min(best, time.perf_counter() - t)
        out[f"stream_{name}_s"] = best
        out[f"stream_{name}_output_peak"] = stats["output_peak"]
        out[f"stream_{name}_input_peak"] = stats["input_peak"]
        print(f"stream {name}: best of 3 {best:.4f} s, {stats['steps']} "
              f"steps, peak input {stats['input_peak']} B, peak output "
              f"held {stats['output_peak']} B", flush=True)
    return out


def main() -> int:
    global api, bitonic, encode2, header, inflate2, match2, pack, parse
    global pipeline2, runs, squeeze
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--part",
                    default="matcher,network,walks,runs,lanes,prep,pack",
                    help="comma-separated: matcher, network, walks, runs, "
                         "lanes, prep, pack, compact, e2e, fused, scan, "
                         "rounds, stream, squeeze")
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose flate_tpu_torch is measured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from flate_tpu_torch import api
    from flate_tpu_torch.device import bitonic, encode2, header, inflate2
    from flate_tpu_torch.device import match2
    from flate_tpu_torch.device import pack, parse, pipeline2, runs
    from flate_tpu_torch.device import squeeze
    card = smi()
    print(card, flush=True)
    print(f"tree: {os.path.abspath(args.tree)}", flush=True)
    res = {"card": card, "tree": os.path.abspath(args.tree)}
    parts = {"matcher": matcher, "network": network, "walks": walks,
             "runs": small_runs, "lanes": lanes, "prep": prep,
             "pack": pack_part, "compact": compact_part, "e2e": e2e,
             "fused": fused,
             "scan": scan_part, "rounds": rounds_part,
             "stream": stream_part, "squeeze": squeeze_part}
    for part in args.part.split(","):
        res.update(parts[part](args.reps))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
