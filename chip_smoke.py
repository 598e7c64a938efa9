"""Chip smoke of the PyTorch/CUDA port (flate_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each:
  1. the card: `nvidia-smi --query-gpu=name,power.limit` (needs CUDA);
  2. the kernel build (nvcc, sm_90a, one compiler per source, all started
     together) and its seconds;
  3. each encode kernel (B1-B5, B9) against its plain PyTorch version on
     the card, at the main path's full-width shapes (64 shards of 128 KiB
     with 32 KiB context) and the knobs of levels 1 and 3 (levels 6 and 9
     and the fp/top-2 matcher: phase 7, the same loop), on one 8 MiB batch
     of bench.py's mixed corpus, every kernel fed with the real outputs of
     the stages before it: exact equality, kernel and plain times, and the
     bound (bytes over the memory rate or the integer operations this
     data needs over the int32 issue rate, whichever is larger); B1, B3
     and B5 (the whole pack_fields call, its offsets included), and B4,
     also replayed from a CUDA graph (graph_ms, the device alone), and a
     line each for torch.sort of B1's int32 keys beside the same keys as
     int64;
  4. the main path: flate_tpu_torch.api.gzip.compress of 32 MiB of the
     mixed corpus at levels 1 and 3 with the launch counters reset just
     before each run and read just after; the output must decode with zlib,
     the 8 MiB mixed input must equal the port's own device="cpu" bytes,
     and every kernel must have launched; the 32 MiB member and the text
     corpus's (3,359,630 B, 26 shards in one batch) must equal the JAX
     package's sha256 (ROUTE_PINNED mixed32M-l1/-l3, text-l1/-l3, a line
     each).  Size against zlib is printed for the mixed corpus (32 and
     8 MiB) and bench.py's text corpus;
  5. the decode kernels (B6 lane walk, B7 serial walk) against their plain
     PyTorch versions on the card at the decode's full width: 8 consecutive
     coded shards of 128 KiB of the text corpus as phase 4 encoded them at
     level 3 (G = 2048, J = 96, NS = S + 128), the per-bit words from the
     port's own pass 1: exact equality, times and bounds as in phase 3,
     with the longest serial chain and the most marks in one lane; then B6
     on one chained-route row chunk (the first lane walk of the chained
     decode of phase 4's 8 MiB level-1 mixed member: up to 64 rows of
     64 KiB spans, 2^19 positions each), with its steps and chain floor;
     B6 is also timed replayed from a CUDA graph (graph_ms, the device
     alone: its calls' host time is as large as the kernel);
  6. the decode path through flate_tpu_torch.api.*.decompress on the card:
     (a) the text corpus as encoded at levels 1 and 3 (indexed route),
     (b) the 32 MiB mixed member of level 3 and the 8 MiB one of level 1
     (segmented shards: re-routed to the chained route), (c) the text corpus
     from CPython's zlib at level 9 (unindexed: chains from bit 0 and from
     the chunk entries the scanner finds every 512 KiB), (d) the first 8
     text shards with walk="serial".  Each output must equal its input;
     the launch counters are reset before and read after each run, and
     each run prints its route, chain heads, seconds, GB/s of output,
     launches, batches walked again serially and re-routes;
  7. (phase 3's loop, run right after it on its batch) B1-B5 at level
     6's and level 9's knobs (K=48, nw=8; K=160, nw=16 with the 3-byte K3
     pass; extension caps 32 and 64; pack after the squeeze, level 9 with
     4096-byte parse blocks), B1 with fingerprint words and B2 ranking by
     them with both outputs (K=48, nw=8, fp=True), B8 (top-2 chain
     extension, also from a CUDA graph) on those outputs, and B9 (parse
     walk) three ways: rows = level 6's parse blocks (8192 x 1024), rows
     = level 9's (2048 x 4096), rows = shards (64 x 131072, the
     parse_walk entry point); and B1/B2 at K = 1024 with 20 exact words
     (rows staged with 65 words, the halo's built from the window) on
     the batch's first 4 rows, whose launches are counted around
     find_matches_fused at those knobs; the squeeze's cost DP
     (flate_squeeze_dp, D1) at levels 6 and 9 (parse blocks of 1,024 and
     4,096, from the greedy pass's code lengths of that level's parse),
     against the plain loop on the same card tensors, also from a CUDA
     graph, its launches those of phase 8's call.  B2 at level
     6 is also timed with the L2 flushed before each launch, and every B2
     case prints, beside its own bound, the bound of reading ne + nf words
     a position as the TPU kernel's inputs are laid out;
  8. the main path: api.gzip.compress at level 6 of 32 MiB mixed, decoded
     by zlib and by the port's own gzip.decompress; levels 2, 4, 5, 7, 8, 9
     on 8 MiB; sizes against zlib at the same level (must be <= 1.0), with
     the text and 8 MiB mixed ratios at levels 6 and 9 beside the JAX
     package's (BENCH_r05.json: sizes, a property of the bytes), the
     text member's sha256 against ROUTE_PINNED text-l6 (and text-l9); CUDA
     bytes against the port's CPU bytes at levels 6 and 9 on 8 shards
     (any difference raises); at every squeeze level (2, 4-9) the count of
     greedy code lengths (ll_bits, d_bits) of the 8 MiB batch that differ
     between card and CPU (any raises); every PROD_PINNED case (levels 1-9
     at 128 KiB shards with 32 KiB context: one full shard and a tail of
     the mixed corpus, ZLIB and RAW at 1, 6, 9, text at 6 and 9, two full
     shards in one batch, the headline's first 8 MiB batch at level 6 and
     in zlib at level 9, and its whole 32 MiB at level 6) encoded
     staged, fused and through api.<ns>.compress, each sha256 equal to the
     JAX package's pin (any other raises), a line a case with its bytes
     and sha256 prefix; the squeeze's rounded code lengths
     of every count pair near a step (length_step_pairs: 8,638,909 pairs,
     totals up to 131,073) on the card against the CPU in one call each
     (any difference raises), beside the pairs where a correctly rounded
     log2 rounds to another length; the shards of 32 MiB mixed and 8 MiB
     text whose greedy histogram holds such a pair, by squeeze level; and
     one batch
     through find_matches_fused(fp=True) -> parse -> fields -> pack ->
     compaction, decoded by zlib, with parse_walk held against
     parse_doubling on the same matches;
  9. B10, the bitonic sort probe's network (tools/bitonic_probe.py), on
     the level-6 payload of phase 3's batch: B1's keys (as u32) and the 8
     carry words of each position (built from the window) padded from 163,840
     to 2^18 (key 0xFFFFFFFF, operands the position), all 171 substages
     in the passes plan_passes cuts them into (printed), through
     device/bitonic.run with the launch counter reset before and read
     after; then against its plain version (exact),
     its first W positions against torch.sort + gather (also timed as the
     library call), and the probe's eight-substage calibrate mix on 8 rows
     with the full sort extrapolated from it;
 10. the streaming encoder through the public entry point:
     api.gzip.compressor(level=6) takes 32 MiB of the mixed corpus in
     writes of 3 MiB + 17 bytes with a flush() at 11 MiB; the bytes written
     by then decode with zlib to the first 11 MiB, the member decodes with
     zlib, every level-6 kernel launched, and its seconds stand beside
     phase 8's one-shot level 6; api.zlib.compress(text x 4, dictionary=
     32 KiB of text) decodes with zlib's zdict and is smaller than without
     it; the member, the bytes written by the flush and both zlib members
     equal the JAX package's sha256 (ROUTE_PINNED stream32M-l6,
     stream32M-l6-flushed, fdict-l6, nodict-l6); a split DeviceEncoder at
     level 6 on 8 shards in batches of 8 gives the same bytes on the card
     and the CPU.
 11. the fused path, compress_device2(fused=True): each batch replays one
     CUDA graph of encode_batch (captured on the first batch of a shape and
     level).  Level 6 on the 32 MiB mixed corpus (4 batches, 2 in flight)
     must give phase 8's level-6 bytes and decode with zlib, with the
     launches counted from the replays equal to phase 8's staged run;
     levels 1 and 9 on 8 MiB must give the staged bytes; level 6 on 8
     shards in batches of 8 the CPU's fused bytes.  Printed: capture and
     instantiate seconds, the graph's node count, replays, launches, one
     replay's device time by CUDA events, and the 32 MiB seconds and GB/s
     beside phase 8's staged level 6;
 12. the mesh encoder on one card: a one-rank NCCL group over a FileStore
     in a temporary directory under build/, compress_mesh2 on 8 MiB mixed
     at level 6 with 64 shards a rank must equal compress_device2(batch=64)
     (phase 8's 8 MiB bytes), compress_to_regions must tile the stream,
     and the group is destroyed.  The exchange between ranks is held on
     the CPU by tests/test_torch_mesh2.py.
 13. the chunk-entry scanner (S1, scan_kernel) on the body of
     zlib.compress(32 MiB mixed, 6), a stream another encoder wrote:
     chunk_entries at the decode's 512 KiB chunks must equal its plain
     version on the host; the offsets the kernel tested (its own count)
     beside those the list needs, at most a tenth of the body's; the
     kernel's time with its state's zero fill (CUDA events, and replayed
     from a CUDA graph, and on an all-zero body of the same length, where
     no offset passes the first test and no chunk has a header, so every
     offset is tested), the whole call's host time, the plain version's,
     and the bound of the list's function, counted by the plain version up
     to each chunk's first header: the bytes those offsets span, the
     headers found and the list written, or the operations (three tests
     an offset, two a Kraft field, one a header bit parsed up to where its
     answer is settled), whichever is larger, with the kernel's share of
     it.  scan_headers (max_out=64) over the body's first 8 MiB, a launch
     a header, must equal its plain version too (its call time and bound
     are printed; no path calls it, so it has no row in the kernel JSON).
     Then api.zlib.decompress of that stream (launch counters reset
     before, read after) must return the input with flate_scan_headers
     launched and more than one chain head, beside
     anyinflate._decompress_member_any(entries=[0]), one chain, and
     decompress_device_any at 128 KiB chunks (over 64 chains: a round's
     rows go through in row chunks) on the same stream: seconds, GB/s of
     output and rounds of each.
 14. blocks past the chained route's old caps, through
     api.zlib/gzip.decompress on the card: zlib's level 6 and memLevel 9
     on 5 and 9 MiB of zeros (blocks of 4,226,814 and 8,453,886 bytes of
     output, resolved in rows of at most 4 MiB), text with a 5 MiB zero
     run, Huffman-only memLevel 9 on 20,000 and 40,000 zero bytes (32,767
     one-bit literals a block, in rows of a symbol slot a bit of the span)
     and a gzip member of the 9 MiB run: each must equal its input with a
     walk kernel launched; GB/s of output, rows cut for the resolve and
     rounds (inflate2.STATS).  Then blocks of more than MAX_SPAN = 2 MiB
     compressed, from the port's host writer (long_block_streams): a
     Huffman-only zlib member of 12 MiB of text (a 6,882,241-byte block)
     and a level-1 gzip member of 6 MiB mixed (about 2.96 MB), each one
     final block, with MAX_SPAN untouched: each must equal its input with
     a walk kernel launched and at least as many continuation rows as
     its block needs past its first row; each beside the same input cut
     into blocks of 2 MiB of input (GB/s, rounds, launches); and each
     through its container's decompressor (io.BytesIO) at a quarter of
     the Decompressor's WINDOW (2 MiB), the Huffman one also at WINDOW:
     each must equal its input with at least as many continuation rows as
     its block needs past its first row, and a peak input of at most
     TRIM + window + FETCH (7,340,032 bytes at 2 MiB): the block is
     carried from window to window, the window does not grow; and a peak
     of output held unserved of at most OUT_CAP + the read's size
     (stream_read).
 15. the round-1 encoder (device/pipeline.compress_device, the JAX
     package's jx/pipeline) at its defaults (shard_len 128 KiB, ctx 32
     KiB, batch 8) at levels 1, 6 and 9 on 8 MiB + 12,345 bytes of the
     mixed corpus (the tail through the host tail encoder), launch counts
     reset before each run and read after it: B3 (flate_small_runs), B4
     (flate_extend), B9 (flate_parse_walk) and B5 (flate_pack) must each
     have launched;
     each member decodes with zlib and with the port's api.gzip.decompress
     on the card and equals the JAX package's sha256 (ROUTE_PINNED
     round1-l1/-l6/-l9); the CUDA bytes equal the port's device="cpu"
     bytes (batch 2) on 2 shards + 12,345 bytes and the JAX package's
     (round1s-l1/-l6/-l9); rows 0-1 of batch 1 (row 0
     primed with 32 KiB of context) through find_matches_device,
     parse_walk, the token stages and pack_tokens on the card and on the
     CPU, equal integer for integer; seconds, GB/s, seconds a batch
     (the host tail encoder's seconds, timed alone, left out) and size
     against zlib.compress at the level (printed, not gated);
     the device time of batch 0's phase1 and of its main-table candidate
     loop (CUDA events), and the loop's share of a batch.  At level 6,
     B3, B4, B9 and B5 at the round-1 shape (8 x 128 KiB) on the inputs
     compress_device gives them in its first batch (recorded from a call
     on that batch), against their plain versions as in phase 3, with
     their bounds; their launches are the level-6 run's.  Then
     parallel.pigz.compress_mesh on a one-rank NCCL group (FileStore
     under build/) on 2 MiB + 12,345 bytes at level 6 must equal
     compress_device (batch 1) and the JAX package's sha256 (pigz-l6).
 16. the rest of the decode API (no new kernel; S1, B6 and B7 run in every
     step): phase 13's foreign stream through zlib.decompressor(io.BytesIO
     (...)) read in (1 << 20) + 17-byte pieces at the Decompressor's
     WINDOW, a quarter and four times it, and phase 8's 32 MiB level-6
     gzip member (chains from its FLT1 shard offsets: no scan, no false
     head) at WINDOW and a quarter, each equal to the input, with launch
     counters and decode stats set to 0 just before and read just after:
     S1, B6 and B7 must launch on the foreign stream; seconds and GB/s
     beside the one-shot's of phases 13 and 8, steps, chain heads and
     rounds a step, false heads, peak input (at most TRIM + window +
     FETCH at every window read, or the phase fails) and peak output
     held unserved (at most OUT_CAP + the read's size, or the phase
     fails); phase 8's 8 MiB member followed by a foreign gzip
     member, whose routes (metrics records) must be indexed then chained;
     phase 10's FDICT member and zlib.compressobj(zdict=32 KiB) over 8 MiB
     decoded with dictionary= (one-shot and streamed); the two streams of
     too_far_streams must raise InvalidMatch; gzip.huffman and gzip.store
     round trips of 8 MiB; roundtrip_cli and decompress_cli in this
     process (exit codes 0, 0, 1, 1); metrics.summary().  Last, the JAX
     package's reader -> writer memory bounds (memory_child, each in a
     process of its own: `python3 chip_smoke.py --memory
     encode|decode|zeros`): 64 MiB of text through
     gzip.compress(ChunkReader(.., 1 << 17), writer=, level=1) after one
     8 MiB batch, zlib.compress(64 MiB, 1) through
     zlib.decompress(ChunkReader(..), writer=) after a 16 MiB stream of
     the same text, and zlib.compress(64 MiB of zeros, 6) the same way
     after the same warm-up (a ratio of 1,000: the output a step decodes
     is resolved a batch of OUT_CAP at a time); the bytes must come out
     right, the host's
     ru_maxrss grow less than 24 MiB over the run, and the run's
     torch.cuda.max_memory_allocated be at most the warm-up's + WINDOW;
     prints the three, seconds and GB/s.
 17. malformed streams, through api.<ns>.decompress and
     api.<ns>.decompressor(io.BytesIO(...)).read_all() on the card: the
     reference's 40-stream corpus (tests/data/fuzz) against FUZZ_CASES,
     the pinned streams of pinned_malformed against their verdicts, 300
     raw, 100 zlib and 100 gzip mutations (mutants over fuzz_seeds, the
     port's own members made on the card, whose length and sha256 are
     printed beside the CPU's and must equal them; gzip also with
     walk="serial")
     against the port's verdicts on the CPU and, where CPython's zlib or
     gzip accepts a stream, against its bytes, four 3 MiB streams of
     large_malformed_streams against their error, and decompress_cli on
     the corpus (exit 0 or 1 as the table says, never 2), with launch
     counters set to 0 just before and read just after: S1, B6 and B7
     must launch.  Prints the verdicts checked, mismatches (any raises),
     launches and seconds.
The JAX pins (sha256 and length of the JAX package's bytes, computed on
the CPU with its Pallas kernels in interpret mode; no JAX runs here):
PROD_PINNED, the headline's shard shape at levels 1-9 through
compress_device2 (phase 8, staged, fused and public), and ROUTE_PINNED,
every other member the card encodes: phase 4's 32 MiB and text members,
phase 8's text member, phase 10's stream, its flushed prefix and the zlib
members with and without a dictionary, phase 15's round-1 members and
the mesh's.  A difference raises.
Then, on lines of their own: the card's name and power limit, the kernel
JSON (every number in it measured in this run, or the bound computed from
this run's inputs), and last `{"ok": true, "device": {...}}`.  Any failure
exits non-zero without the last line.  Imports nothing of JAX or flate_tpu.
About 450-550 s on an H100 (the kernel build ~6 s, the CPU twins of
phases 8 and 10 ~30-55 s, the plain versions' host loops ~25 s, phase 13
~15 s, phase 14 ~65 s, most of it the host writer's long blocks and their
cut twins, phase 15 ~15 s with its CPU twins, phase 16 ~80 s, of which
the two memory checks' processes ~45 s; phase 17 ~45 s, half of it its
CPU twins).
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

B, S, CTX = 64, 128 * 1024, 32 * 1024
HBM_BYTES_PER_S = 3.35e12            # H100 SXM memory rate (data sheet)
# 32-bit integer add/compare/logic issue rate: 64 lanes per SM per clock
# (CUDA programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz
# boost clock.  All the kernels do integer work only.
INT_OPS_PER_S = 64 * 132 * 1.98e9
# one chain step from shared memory (a load and its address) of a walker
# alone on its SM, measured by tools/torch_kernel_probe.py --part walks on
# an H100 80GB HBM3 at 700 W (PERF.md section 6): the chain floor of a walk
# is its longest chain's steps times this
CHAIN_STEP_NS = 20.3
HERE = os.path.dirname(os.path.abspath(__file__))
LEVELS = (1, 3)                  # 32 MiB end to end in phase 4
KERNEL_LEVELS = (1, 3, 6, 9)     # knobs at which B1-B5 and B9 are held to plain
# size / zlib's size at the same level, from the JAX package's last bench
# (BENCH_r05.json size_vs_zlib_corpora): byte counts, equal on any hardware
JAX_RATIOS = {6: {"text": 0.9857, "mixed 8 MiB": 0.9399},
              9: {"text": 0.9787, "mixed 8 MiB": 0.9365}}
# The headline's shard shape held to the JAX package's bytes: (level,
# shard_len, ctx, batch, container, input) -> sha256 of
# flate_tpu.jx.pipeline2.compress_device2(interpret=True) on
# prod_input(input) (index on for gzip).  One full shard and a tail in
# batches of 1 carry the context from batch 1 to batch 2; "mixed2" puts two
# full shards in one batch; "mixed8M" is the headline's first batch (at
# level 6 in gzip, and at level 9 in zlib: the deployment pigz -9 -z) and
# "mixed32M" the headline's whole 32 MiB at level 6 (4 batches).  Phase
# 8 encodes each on the card; tests/test_torch_prodshape.py holds the
# port's CPU bytes to them and recomputes them with the JAX package (slow).
PROD_TAIL = 12_345
PROD_PINNED = {
    (1, S, CTX, 1, "GZIP", "mixed"):
        "aa473072938afa5ab9a3738076cdd03093dcffa1fda7f5663616e3fdd77c4fc0",
    (2, S, CTX, 1, "GZIP", "mixed"):
        "a4b060c11940380563d7f2419ce93449e6320ae7f3604a08287ae4450142c291",
    (3, S, CTX, 1, "GZIP", "mixed"):
        "7ac1ceaba9c43a2c59fefc23aa2c3da69f731b43a83ace65d4db6b0ca355294a",
    (4, S, CTX, 1, "GZIP", "mixed"):
        "12e3457b40b95063cf5cac7264578bc23869263f2d114dd7ea7994cc622eee33",
    (5, S, CTX, 1, "GZIP", "mixed"):
        "716beb4fe20159434d64d79b784652b279a407a25e46c55b62c38aa7beb5f1c4",
    (6, S, CTX, 1, "GZIP", "mixed"):
        "fc37dc04c930eb5a5382c980dfc2e1ba0859e568fa792a2b69f10175b903986b",
    (7, S, CTX, 1, "GZIP", "mixed"):
        "7a9135137b218af9afe5e0d5f71c1fabb55feb69b162362940de896a60dbf891",
    (8, S, CTX, 1, "GZIP", "mixed"):
        "2a836a9b48a56b7a5e50183bedc823fb5d4ce67612c1e0d02047488a340a2c7f",
    (9, S, CTX, 1, "GZIP", "mixed"):
        "2e7786d8f208f814d4f66ac53ad7664082c7a42f5ac1d22f95db34d63b847968",
    (1, S, CTX, 1, "ZLIB", "mixed"):
        "5cac693b8b6bd5cbce90213ee1001d619b5704e02d6fe1842a460214f933d601",
    (6, S, CTX, 1, "ZLIB", "mixed"):
        "0e7c2b9b0ca70843ef1db1457fd94b8ec1cbbf8df612c21de52ca9be6fe57d5b",
    (9, S, CTX, 1, "ZLIB", "mixed"):
        "9b17f94aa94e6e05e1523864b4b9d29a9f7325a58be78d386aa219f4da621aea",
    (1, S, CTX, 1, "RAW", "mixed"):
        "18ed449bf35db8a0059e60e7551cc9da074f56f21e10c5dd65855ab623edd929",
    (6, S, CTX, 1, "RAW", "mixed"):
        "6da9ceecf54a82484fceead38e4fae925bcd9fa74acd86c1663fe9cb295621c7",
    (9, S, CTX, 1, "RAW", "mixed"):
        "79d0c47d8d5ea5d285d8799655f843d50b3a3ccaf75834d91dac2c3f440cd4c8",
    (6, S, CTX, 1, "GZIP", "text"):
        "52597f74e2383e038bd1f95ad2587c2d8ee3addbb113a60439c85202c7514ebe",
    (9, S, CTX, 1, "GZIP", "text"):
        "06649e50d1eb3d8ceccbe606d11378dcee6de3bd8cb4dc821f3422576a360a3c",
    (6, S, CTX, 2, "GZIP", "mixed2"):
        "06db386c63021a874e08b5b9fb91d13d76b4edb410ff0eff5fb8d73e0d51decc",
    (6, S, CTX, 64, "GZIP", "mixed8M"):
        "b37c793cf797673ffe675a800815962fadb3762590cb0b9e7be46a2503668296",
    (6, S, CTX, 64, "GZIP", "mixed32M"):
        "b09af66f1a0015e7137c713ef2a702e2d989a26f2abe49fbebb0b7b617181ea9",
    (9, S, CTX, 64, "ZLIB", "mixed8M"):
        "0be428a594d5d0ba34224757a29b91609df05bdc2ebecd087a962882d70f000b",
}


def text_corpus(size: int) -> bytes:
    """RFC 1951's text repeated to `size` bytes (bench.py's text corpus)."""
    path = os.path.join(HERE, "tests", "data", "rfc1951.txt")
    with open(path, "rb") as fh:
        t = fh.read()
    return (t * (size // len(t) + 1))[:size]


def length_step_pairs(max_total: int = 131_073) -> tuple:
    """(h, total) int64 arrays: every count pair 1 <= h < total <=
    max_total within two counts of a step of the squeeze's rounded code
    length, h = total * 2^-(k + 0.15) for k = 1..14, each pair once
    (8,638,909 at the default: a 128 KiB shard's tokens and its EOB)."""
    t = np.arange(2, max_total + 1, dtype=np.int64)
    keys = []
    for k in range(1, 15):
        h0 = np.rint(t * 2.0 ** -(k + 0.15)).astype(np.int64)
        for d in range(-2, 3):
            h = h0 + d
            ok = (h >= 1) & (h < t)
            keys.append(t[ok] << 20 | h[ok])
    key = np.unique(np.concatenate(keys))
    return key & ((1 << 20) - 1), key >> 20


def mixed_corpus(size: int) -> bytes:
    """64 KiB of RFC 1951 text, then 16 KiB of seeded random bytes,
    repeated to `size` bytes (bench.py's mixed corpus, seed 11)."""
    rng = np.random.default_rng(11)
    blocks, n = [], 0
    t = text_corpus(1 << 16)
    while n < size:
        blocks.append(t)
        r = rng.integers(0, 256, 1 << 14, dtype=np.uint8).tobytes()
        blocks.append(r)
        n += len(t) + len(r)
    return b"".join(blocks)[:size]


def prod_input(name: str) -> bytes:
    """A PROD_PINNED case's input: bench.py's mixed or text corpus cut to
    one full shard and PROD_TAIL bytes ("mixed", "text"), the mixed corpus
    cut to two full shards and the tail ("mixed2"), to the first 8 MiB
    batch ("mixed8M") or to the headline's 32 MiB ("mixed32M")."""
    n = {"mixed": S + PROD_TAIL, "text": S + PROD_TAIL,
         "mixed2": 2 * S + PROD_TAIL, "mixed8M": B * S,
         "mixed32M": 4 * B * S}[name]
    return (text_corpus if name == "text" else mixed_corpus)(n)


def prod_id(case) -> str:
    level, shard_len, ctx, batch, container, name = case
    return f"l{level}-b{batch}-{container}-{name}"


# Phase 10's stream: writes of STREAM_PIECE bytes, a flush at STREAM_CUT.
STREAM_CUT, STREAM_PIECE = 11 << 20, (3 << 20) + 17
ROUTE_INPUTS = {
    "mixed32M": lambda: mixed_corpus(4 * B * S),
    "text": lambda: text_corpus(3_359_630),     # bench.py's text corpus
    "text4": lambda: text_corpus(32 * 1024) * 4,
    "r1": lambda: mixed_corpus((8 << 20) + PROD_TAIL),
    "r1s": lambda: mixed_corpus(2 * S + PROD_TAIL),
    "pigz": lambda: mixed_corpus((2 << 20) + PROD_TAIL),
}
# Every other member the card encodes, held to the JAX package's bytes:
# case -> (input, the JAX call, length, sha256).  The calls run with the
# headline's CompressOptions(level, shard_len=S, ctx=CTX, batch=B,
# interpret=True) where they take opts; the round-1 ones
# (flate_tpu.jx.pipeline, no Pallas) at their defaults (128 KiB shards,
# 32 KiB context, batch 8).  Every pin is the JAX member itself: each
# decodes with zlib, so none needs the fixed-block repair of ROADMAP C.10.
# Phases 4, 8, 10 and 15 compare the bytes they already make with these;
# tests/test_torch_routepins.py holds the port's CPU bytes to them and
# recomputes them with the JAX package (slow).
ROUTE_PINNED = {
    "stream32M-l6": (
        "mixed32M", "gzip.compressor(level=6, opts, device=True)",
        14_038_353,
        "44c6d88f9dffa27e666627821a04a35d4a31eb6d4e0f6df897be407ba91f1e03"),
    "stream32M-l6-flushed": (
        "mixed32M", "gzip.compressor(level=6, opts, device=True)",
        4_818_866,
        "7e9af3df49795da0f023b766ef130f2a64c720116f77294db01fff4d0897af16"),
    "fdict-l6": (
        "text4", "zlib.compress(level=6, opts, dictionary=zd, device=True)",
        3_714,
        "105e74b32f98c6546bc4bb768cb5d57b97186d67e07f184df70d9af88464ed79"),
    "nodict-l6": (
        "text4", "zlib.compress(level=6, opts, device=True)",
        12_754,
        "8c35c8bc3aa324db365a87970e9abb0f100553355db495df5fa67c0f79b6b794"),
    "round1-l1": (
        "r1", "jx.pipeline.compress_device(level=1, GZIP)",
        3_991_929,
        "3616b7af0e5a3aab9c3fd077bf46d406bb475ed856687d4011fb0715d1ae8c69"),
    "round1-l6": (
        "r1", "jx.pipeline.compress_device(level=6, GZIP)",
        3_771_948,
        "b553b8ccf8be0fd4ac3426b3aceacbd3becc14a1a28b7c4dc015040e75551e65"),
    "round1-l9": (
        "r1", "jx.pipeline.compress_device(level=9, GZIP)",
        3_761_690,
        "d831dc51c7afdae6daf0117a0f9b6818307c654943f60e47572692ad080f5ba6"),
    "round1s-l1": (
        "r1s", "jx.pipeline.compress_device(level=1, GZIP)",
        126_445,
        "465315ea7c480140b21c21e9a57aaace7203b1f3b7ca38c852e177e2be850f43"),
    "round1s-l6": (
        "r1s", "jx.pipeline.compress_device(level=6, GZIP)",
        119_240,
        "6f270a64f5a1952a1336e5d744a9e7909bae3047382cf89dd4def9c6fcc64b87"),
    "round1s-l9": (
        "r1s", "jx.pipeline.compress_device(level=9, GZIP)",
        118_919,
        "a9cc3286ecafc89c716180efc90ebd8ec2bd2384f1d1e5a0c776bcbf959a95ee"),
    "pigz-l6": (
        "pigz", "jx.pipeline.compress_device(level=6, GZIP, batch=1)",
        939_442,
        "5488081ecc414bfa77884b878f8680119ef0883bfa2f83f121b6a28b645ef92b"),
    "mixed32M-l1": (
        "mixed32M", "jx.pipeline2.compress_device2(level=1, GZIP, S, CTX, B)",
        15_536_103,
        "115d4ec02f2f33cd6142c7579bc30b5116f2c29a051aa08a2fdb2d77c19e605b"),
    "mixed32M-l3": (
        "mixed32M", "jx.pipeline2.compress_device2(level=3, GZIP, S, CTX, B)",
        14_762_681,
        "c496547091840e39c6131daf0e9028446db3cbd7820002415aaf8a3e20db93b6"),
    "text-l1": (
        "text", "jx.pipeline2.compress_device2(level=1, GZIP, S, CTX, B)",
        1_100_757,
        "0e30bf2bd887a5c0d98cb2b11ea7aea31535b75539be587b9261507848b9c5a0"),
    "text-l3": (
        "text", "jx.pipeline2.compress_device2(level=3, GZIP, S, CTX, B)",
        1_003_409,
        "8c1ad42e3de81c17d85744b3fb1f4f8daaa169af801227b1ef1c4ad126a21d1a"),
    "text-l6": (
        "text", "jx.pipeline2.compress_device2(level=6, GZIP, S, CTX, B)",
        909_575,
        "519fb3c16a19a9db00d875283cb8861232b59ddf5aedea1b2ab1ca98271cc42e"),
    "text-l9": (
        "text", "jx.pipeline2.compress_device2(level=9, GZIP, S, CTX, B)",
        898_071,
        "91e61d8c124febf8a2a504e7223a13aac47073a382c50d65bcf23a1468ac0d25"),
}


def route_input(name: str) -> bytes:
    """A ROUTE_PINNED case's input (ROUTE_INPUTS)."""
    return ROUTE_INPUTS[name]()


def stream_writes(c, sink, data: bytes) -> tuple:
    """Phase 10's writes into compressor c, which writes to sink: pieces of
    STREAM_PIECE bytes, the one that crosses STREAM_CUT stopped there and
    followed by a flush; returns (member, sink's bytes after the flush)."""
    at, flushed = 0, None
    while at < len(data):
        end = min(at + STREAM_PIECE, len(data))
        if flushed is None and end >= STREAM_CUT:
            end = STREAM_CUT
        c.write(data[at:end])
        at = end
        if flushed is None and at == STREAM_CUT:
            c.flush()
            flushed = sink.getvalue()
    c.finish()
    return sink.getvalue(), flushed


def check_route_pin(case: str, blob: bytes, phase: int) -> None:
    """Prints the case's line and raises unless blob is the pinned
    member."""
    _inp, _call, n, pin = ROUTE_PINNED[case]
    sha = hashlib.sha256(blob).hexdigest()
    print(f"[{phase}] JAX pin {case}: {len(blob)} bytes, sha256 "
          f"{sha[:12]} (pin {n} bytes, {pin[:12]}): equal "
          f"{sha == pin and len(blob) == n}", flush=True)
    if sha != pin or len(blob) != n:
        raise AssertionError(f"{case}: {len(blob)} bytes, sha256 {sha} != "
                             f"the JAX package's {n} bytes, {pin}")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (the caller has run it
    once before)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of one fn() launch: reps launches captured in one CUDA
    graph and replayed, so no host time sits between them (fn must not
    synchronise)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    ms = cuda_ms(g.replay, 3) / reps
    del g
    return ms


def host_ms(fn, reps: int) -> float:
    """Host time of one fn() call, which returns before the card is done
    (the card waits on the host when this is above the kernel's device
    time)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean device time of fn() with the L2 flushed before each launch: a
    64 MB write, then a spin that keeps the card busy while the host
    enqueues fn, both outside the timed span."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    total = 0.0
    for _ in range(reps):
        scratch.fill_(1)
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def most_marks(mask: torch.Tensor, G: int) -> int:
    """The most marks of a lane-walk mask (B, N) in one lane of G."""
    return int(mask.reshape(mask.shape[0], -1, G).sum(dim=2).max())


def chained_chunk(api, inflate2, blob: bytes, **kw):
    """(word, start, nbits) of the first lane walk the chained decode of
    `blob` makes (a member whose segmented shards re-route it there, maybe
    after an indexed batch): the first row chunk of its first round,
    recorded from the call.  kw goes to api.gzip.decompress."""
    seen = []
    real = inflate2._lane_walk
    base = inflate2.STATS["chained_members"]

    def record(word, start, nbits, **kw):
        if not seen and inflate2.STATS["chained_members"] > base:
            seen.append((word.clone(), start.clone(), nbits.clone()))
        return real(word, start, nbits, **kw)

    inflate2._lane_walk = record
    try:
        api.gzip.decompress(blob, **kw)
    finally:
        inflate2._lane_walk = real
    if not seen:
        raise AssertionError("the chained decode made no lane walk")
    return seen[0]


def big_block_streams():
    """(name, container, stream, input) of valid zlib/gzip output whose
    blocks exceed the chained route's old caps: more than 4 MiB of output
    (zlib's 16,383 or, at memLevel 9, GNU gzip's buffer size, 32,767
    matches of 258 bytes a block on zero runs) or more symbols than twice
    their compressed bytes (Huffman-only zeros, a 1-bit literal a byte).
    The tests decode the same streams on the CPU."""
    def mem9(data, wbits, strategy=zlib.Z_DEFAULT_STRATEGY):
        c = zlib.compressobj(6, zlib.DEFLATED, wbits, 9, strategy)
        return c.compress(data) + c.flush()

    zeros5, zeros9 = b"\0" * (5 << 20), b"\0" * (9 << 20)
    text = text_corpus(60_000)
    c = zlib.compressobj(6)              # a block starts at the zero run
    run = c.compress(text) + c.flush(zlib.Z_FULL_FLUSH) \
        + c.compress(zeros5 + text) + c.flush()
    return [
        ("zeros_5mib_l6", "ZLIB", zlib.compress(zeros5, 6), zeros5),
        ("zeros_9mib_mem9", "ZLIB", mem9(zeros9, 15), zeros9),
        ("text_5mib_run", "ZLIB", run, text + zeros5 + text),
        ("huffman_20000", "ZLIB",
         mem9(zeros9[:20000], 15, zlib.Z_HUFFMAN_ONLY), zeros9[:20000]),
        ("huffman_40000", "ZLIB",
         mem9(zeros9[:40000], 15, zlib.Z_HUFFMAN_ONLY), zeros9[:40000]),
        ("gzip_zeros_9mib_mem9", "GZIP", mem9(zeros9, 31), zeros9),
    ]


def member(container: str, raw: bytes, data: bytes) -> bytes:
    """A zlib or gzip member around raw deflate bytes that decode to
    `data`."""
    if container == "GZIP":
        return (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff" + raw
                + zlib.crc32(data).to_bytes(4, "little")
                + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))
    return b"\x78\x01" + raw + zlib.adler32(data).to_bytes(4, "big")


def host_blocks(data: bytes, piece: int, huffman: bool) -> bytes:
    """Raw deflate of `data` from the port's host writer, a block for each
    `piece` bytes of input, as its host Compressor writes a block a shard:
    Huffman-only, or level 1 (block.write_block picks the cheapest kind),
    the last block final."""
    from flate_tpu_torch import bitpack, block, deflate
    sink = bitpack.BitSink()
    for lo in range(0, len(data), piece):
        d = data[lo:lo + piece]
        final = lo + piece >= len(data)
        if huffman:
            block.write_huffman_only(sink, d, final)
        else:
            block.write_block(sink, deflate.tokenize_shard(
                np.frombuffer(d, np.uint8), None, 1), final, raw=d)
    return sink.getvalue()


def long_block_streams(text_size: int = 12 << 20, mixed_size: int = 6 << 20):
    """(name, container, stream, input) of one final block each whose
    compressed length passes the chained route's MAX_SPAN (2 MiB):
    Huffman-only over `text_size` bytes of the text corpus as a zlib
    member (12 MiB: a 6,882,241-byte block, more than MAX_S of output
    too) and level 1 over `mixed_size` bytes of the mixed corpus as a gzip
    member (6 MiB: about 2.96 MB).  The card tests make them small and cut
    MAX_SPAN instead."""
    text, mixed = text_corpus(text_size), mixed_corpus(mixed_size)
    return [
        ("huffman_12mib_text", "ZLIB",
         member("ZLIB", host_blocks(text, len(text), True), text), text),
        ("level1_6mib_one_block", "GZIP",
         member("GZIP", host_blocks(mixed, len(mixed), False), mixed),
         mixed),
    ]


def too_far_streams():
    """(container name, stream) of a match that reaches before the
    stream's start: a raw fixed block of the literal "a", a match of
    length 3 at distance 2 and the end of block, and the same body as a
    zlib member whose footer is the Adler-32 of the zero-filled b"a\0a\0".
    CPython's zlib rejects both ("invalid distance too far back"), the JAX
    package raises InvalidMatch, and so must the port."""
    def rev(v, n):
        return int(format(v, f"0{n}b")[::-1], 2)

    fields = [(1, 1), (1, 2), (rev(0x30 + 97, 8), 8), (rev(1, 7), 7),
              (rev(1, 5), 5), (rev(0, 7), 7)]
    v = n = 0
    for val, width in fields:
        v |= val << n
        n += width
    raw = v.to_bytes((n + 7) // 8, "little")
    member = b"\x78\x01" + raw + zlib.adler32(b"a\0a\0").to_bytes(4, "big")
    return [("RAW", raw), ("ZLIB", member)]



# The reference's malformed-stream corpus, tests/data/fuzz (its table is
# tests/test_inflate_fuzz.py CASES, which a CPU test holds this copy to):
# (input name, expected output: a file name, bytes or None, error class).
FUZZ_CASES = [
    ("deflate-stream", "deflate-stream.expect", None),
    ("empty-distance-alphabet01", b"", None),
    ("empty-distance-alphabet02", b"", None),
    ("end-of-stream", None, "EndOfStream"),
    ("invalid-distance", None, "InvalidMatch"),
    ("invalid-tree01", None, "IncompleteHuffmanTree"),
    ("invalid-tree02", None, "IncompleteHuffmanTree"),
    ("invalid-tree03", None, "IncompleteHuffmanTree"),
    ("lengths-overflow", None, "InvalidDynamicBlockHeader"),
    ("out-of-codes", None, "InvalidCode"),
    ("puff01", None, "WrongStoredBlockNlen"),
    ("puff02", None, "EndOfStream"),
    ("puff03", b"\x0a", None),
    ("puff04", None, "InvalidCode"),
    ("puff05", None, "EndOfStream"),
    ("puff06", None, "EndOfStream"),
    ("puff08", None, "InvalidCode"),
    ("puff09", b"P", None),
    ("puff10", None, "InvalidCode"),
    ("puff11", None, "InvalidMatch"),
    ("puff12", None, "InvalidDynamicBlockHeader"),
    ("puff13", None, "IncompleteHuffmanTree"),
    ("puff14", None, "EndOfStream"),
    ("puff15", None, "IncompleteHuffmanTree"),
    ("puff16", None, "InvalidDynamicBlockHeader"),
    ("puff17", None, "InvalidDynamicBlockHeader"),
    ("fuzz1", None, "InvalidDynamicBlockHeader"),
    ("fuzz2", None, "InvalidDynamicBlockHeader"),
    ("fuzz3", None, "InvalidMatch"),
    ("fuzz4", None, "OversubscribedHuffmanTree"),
    ("puff18", None, "OversubscribedHuffmanTree"),
    ("puff19", None, "OversubscribedHuffmanTree"),
    ("puff20", None, "OversubscribedHuffmanTree"),
    ("puff21", None, "OversubscribedHuffmanTree"),
    ("puff22", None, "OversubscribedHuffmanTree"),
    ("puff23", None, "InvalidDynamicBlockHeader"),
    ("puff24", None, "InvalidDynamicBlockHeader"),
    ("puff25", None, "OversubscribedHuffmanTree"),
    ("puff26", None, "InvalidDynamicBlockHeader"),
    ("puff27", None, "InvalidDynamicBlockHeader"),
]


def fuzz_case(name: str, expect) -> tuple:
    """(input bytes, expected output or None) of a FUZZ_CASES entry."""
    fuzz = os.path.join(HERE, "tests", "data", "fuzz")
    with open(os.path.join(fuzz, f"{name}.input"), "rb") as fh:
        data = fh.read()
    if isinstance(expect, str):
        with open(os.path.join(fuzz, expect), "rb") as fh:
            expect = fh.read()
    return data, expect


FUZZ_TEXT = b"the quick brown fox jumps over the lazy dog " * 40


def fuzz_mixed() -> bytes:
    """The input of the port's own seed streams: the text, 2,048 seeded
    random bytes (one random.Random(3)) and the text again, so its members
    mix stored and coded shards."""
    import random
    rng = random.Random(3)
    return FUZZ_TEXT + bytes(rng.randrange(256) for _ in range(2048)) \
        + FUZZ_TEXT


def own_member(container: str, device) -> bytes:
    """The port's own member of fuzz_mixed() in `container` (RAW, ZLIB or
    GZIP: with the FLT1 index), at shard_len 2048, ctx 1024, batch 2."""
    from flate_tpu_torch.containers import Container
    from flate_tpu_torch.device import pipeline2
    return pipeline2.compress_device2(
        fuzz_mixed(), level=6, container=Container[container],
        shard_len=2048, ctx=1024, batch=2, device=device)


def fuzz_seeds(container: str, own: bytes) -> list:
    """The valid streams the mutations start from: for RAW the seeds of
    tests/test_decoder_fuzz_differential.py (zlib at levels 0, 1, 6, 9, a
    byte ramp, a sync-flushed stream) and the port's own member `own`; for
    ZLIB zlib's members at those levels and `own`; for GZIP CPython's gzip
    at levels 1, 6 and 9 (mtime 0) of fuzz_mixed(), `own` (whose mixed
    shard re-routes it to the chained route) and OWN_GZIP_167 (all coded
    shards: the indexed route decodes it)."""
    if container == "RAW":
        seeds = [zlib.compress(FUZZ_TEXT, lv)[2:-4] for lv in (0, 1, 6, 9)]
        seeds.append(zlib.compress(bytes(range(256)) * 32, 6)[2:-4])
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        seeds.append(co.compress(FUZZ_TEXT) + co.flush(zlib.Z_SYNC_FLUSH)
                     + co.flush())
    elif container == "ZLIB":
        seeds = [zlib.compress(FUZZ_TEXT, lv) for lv in (0, 1, 6, 9)]
    else:
        seeds = [gzip.compress(fuzz_mixed(), lv, mtime=0) for lv in (1, 6, 9)]
        seeds.append(OWN_GZIP_167)
    return seeds + [own]


def mutants(seeds: list, n: int, seed: int = 20260817) -> list:
    """n mutations of the seed streams, as the JAX package's mutation
    differential makes them: a seed, then 1-6 edits of a bit flip (1/2), a
    byte deleted (1/4) or a byte inserted (1/4)."""
    import random
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        s = bytearray(rng.choice(seeds))
        for _ in range(rng.randint(1, 6)):
            op = rng.random()
            if op < 0.5 and s:
                s[rng.randrange(len(s))] ^= 1 << rng.randrange(8)
            elif op < 0.75 and s:
                del s[rng.randrange(len(s))]
            else:
                s.insert(rng.randrange(len(s) + 1), rng.randrange(256))
        out.append(bytes(s))
    return out


# The port's own gzip member (own_member("GZIP", ...) of the text, 2,048
# bytes of 0x79 and the text: a 44-byte header with a 32-byte FLT1 extra
# field, shards of 68, 27 and 20 bytes, the footer).
OWN_GZIP_167 = bytes.fromhex(
    "1f8b0804000000000003200046541c000100030044000000000800001b0000000008"
    "000014000000c0050000eccac711c0201004c154363519e4a513de444f910001503b"
    "df697728687f2e376623f1c32609977f7f0b09caa0ed672a19abeca0a5a51dcbd2d2"
    "8e6c33eb56010000ffff1a05a360148c5c300a46c1700684da0a84da15c35d2d0000"
    "00ffff1a553baa7654edc8553baa7668ab05040000ffffed14587ec0150000")


def pinned_malformed() -> list:
    """(name, container, stream, expected: the output or an error class
    name) of streams on which the port once gave another verdict than the
    JAX package's host decode:
    - OWN_GZIP_167 with bit 2 of byte 38 flipped (inside the FLT1 index:
      the index no longer describes the body, which is intact) decodes to
      its input; with bit 3 of byte 158 flipped (the NLEN of the empty
      stored block that ends the body) it raises WrongStoredBlockNlen;
    - raw streams whose first block is fixed, non-final and starts with a
      match of length 3 at distance 1 (no output before it: InvalidMatch,
      the first error in stream order), then: a code for litlen symbol 286
      and 64 zero bits; three literals "A" and the end, cut at a byte; the
      end of block and a stored block with LEN 5 and NLEN 5; the end of
      block and a final dynamic block whose litlen lengths are 2, 0 x 255,
      2 (incomplete), or 1, 1, 0 x 254, 1 (oversubscribed)."""
    member = OWN_GZIP_167
    text = FUZZ_TEXT + b"y" * 2048 + FUZZ_TEXT
    flip38, flip158 = bytearray(member), bytearray(member)
    flip38[38] ^= 1 << 2
    flip158[158] ^= 1 << 3
    return [
        ("own gzip member, byte 38 bit 2", "GZIP", bytes(flip38), text),
        ("own gzip member, byte 158 bit 3", "GZIP", bytes(flip158),
         "WrongStoredBlockNlen"),
        ("too far, then an invalid code", "RAW",
         bytes.fromhex("0282310000000000000000"), "InvalidMatch"),
        ("too far, then the stream is cut", "RAW", bytes.fromhex("02024747"),
         "InvalidMatch"),
        ("too far, then a stored block's NLEN", "RAW",
         bytes.fromhex("02024000050005000000000000"), "InvalidMatch"),
        ("too far, then an incomplete tree", "RAW",
         bytes.fromhex("0202400170400200000020a8ffab1300000000"),
         "InvalidMatch"),
        ("too far, then an oversubscribed tree", "RAW",
         bytes.fromhex("020240017040020000002048ff9f5600000000"),
         "InvalidMatch"),
    ]


def large_malformed_streams(size: int = 3 << 20) -> list:
    """(name, container, stream, error class name) of malformed streams of
    `size` bytes of the mixed corpus, longer than the decode's 512 KiB
    chunks (the scanner gives them chain heads past bit 0), each with the
    error the serial decode meets first: zlib's level 6 cut at 3/4
    (EndOfStream) or with its Adler-32 flipped (WrongZlibChecksum); a zlib
    stream full-flushed after 2/3 of the input whose flush block's NLEN
    is flipped (WrongStoredBlockNlen); the same as a raw stream made with
    a preset dictionary of the input's first 32 KiB and decoded without
    it (its first matches reach before the start: InvalidMatch comes
    first)."""
    data = mixed_corpus(size)
    cut = 2 * size // 3
    whole = zlib.compress(data, 6)

    def flushed(wbits, **kw):
        c = zlib.compressobj(6, zlib.DEFLATED, wbits, **kw)
        head = bytearray(c.compress(data[:cut]) + c.flush(zlib.Z_FULL_FLUSH))
        head[-1] ^= 1                 # NLEN of the flush's empty block
        return bytes(head) + c.compress(data[cut:]) + c.flush()

    return [
        ("zlib cut at 3/4", "ZLIB", whole[:len(whole) * 3 // 4],
         "EndOfStream"),
        ("zlib Adler-32 flipped", "ZLIB", whole[:-1] + bytes([whole[-1] ^ 1]),
         "WrongZlibChecksum"),
        ("zlib flush NLEN flipped", "ZLIB", flushed(15),
         "WrongStoredBlockNlen"),
        ("raw with a dictionary, flush NLEN flipped", "RAW",
         flushed(-15, zdict=data[:32 * 1024]), "InvalidMatch"),
    ]


def verdict(fn) -> tuple:
    """(bytes, None) when fn() returns, (None, the error class name) when
    it raises one of the port's stream errors."""
    from flate_tpu_torch import errors
    try:
        return fn(), None
    except errors.FlateError as e:
        return None, type(e).__name__


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from flate_tpu_torch import _build, api
    from flate_tpu_torch.containers import Container, parse_header
    from flate_tpu_torch.device import anyinflate, bitonic, encode2
    from flate_tpu_torch.device import graphs, inflate2, match2, pack
    from flate_tpu_torch.device import parse, pipeline2, runs, scan, squeeze
    from flate_tpu_torch.device import to_i32
    from flate_tpu_torch.shard_index import parse_index_extra

    card = smi()
    print(f"[1] device: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    _build.build(verbose=True)
    _build.library()
    print(f"[2] kernel build ({len(_build.SOURCES)} sources in parallel): "
          f"{time.time() - t0:.3f} s", flush=True)

    # ---- phase 3: kernels against their plain versions, full width ----
    dev = torch.device("cuda")
    head = mixed_corpus(CTX + B * S)     # context, then one 8 MiB batch
    ctx0 = torch.frombuffer(bytearray(head[:CTX]), dtype=torch.uint8).to(dev)
    shards = torch.frombuffer(bytearray(head[CTX:]), dtype=torch.uint8
                              ).reshape(B, S).to(dev)
    window = pipeline2._prime_windows(shards, ctx0, CTX)
    W = window.shape[1]
    Wp = -(-W // match2.TILE) * match2.TILE
    ctx_len = torch.full((B,), CTX, dtype=torch.int32, device=dev)
    valid = torch.full((B,), S, dtype=torch.int32, device=dev)
    valid[-1] = S - 12345                    # one tail shard
    min_src = (CTX - ctx_len).to(torch.int32)
    limit = (CTX + valid).to(torch.int32)
    finals = torch.zeros(B, dtype=torch.int32, device=dev)
    finals[-1] = 1

    cases = []
    launches = {}         # main-path run -> launch counts by entry point

    def case(phase, path, label, entry, replaces, kernel, plain, bytes_moved,
             ops, reps=20, note=None, library=None, extra=None, graph=False):
        """entry: the C entry point; path: the main-path run whose launch
        count the case reports; bytes_moved: what the function must move
        at its own widths (u32 keys, words and field values), each input
        read once and each output written once; ops: the integer
        operations this run's data needs (a lower bound), or a function of
        the kernel's outputs that gives them; note: what else the launch
        count of this entry on that path covers; library: one PyTorch call
        that computes the same function, timed beside the kernel (the port
        never calls it); extra: more keys, measured in this run, for the
        case's line; graph: also time the kernel replayed from a CUDA graph
        (graph_ms: the device alone, no host time between launches).  The
        kernel's run that is compared is the warm-up of its timed ones;
        the plain version's is timed itself when it takes a second or more
        (its host loop has nothing to warm), else it is the warm-up of one
        timed run."""
        def outputs(r):
            return r if isinstance(r, tuple) else (r,)

        k_out = outputs(kernel())
        got = []
        plain_ms = cuda_ms(lambda: got.append(outputs(plain())), 1)
        p_out = got[0]
        err = 0
        for a, b in zip(k_out, p_out, strict=True):
            if a.shape != b.shape:
                raise AssertionError(f"{label}: shape {a.shape} vs {b.shape}")
            if a.numel() == 0:                   # B1's fingerprints at nf = 0
                continue
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max().item()))
        if err != 0:
            raise AssertionError(f"{label}: kernel != plain "
                                 f"(max abs err {err})")
        if callable(ops):
            ops = ops(k_out)
        ms = cuda_ms(kernel, reps)
        if graph:
            extra = {**(extra or {}), "graph_ms": graph_ms(kernel, reps)}
        if plain_ms < 1000:
            plain_ms = cuda_ms(plain, 1)
        library_ms = None
        if library is not None:
            library()
            library_ms = cuda_ms(library, reps)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = float(ops) / INT_OPS_PER_S * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        bound_ms = max(bytes_ms, ops_ms)
        cases.append(dict(name=label, entry=entry, path=path,
                          route="cuda", source=_build.source_of(entry),
                          replaces=replaces,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms))
        if note:
            cases[-1]["launches_cover"] = note
        cases[-1].update(extra or {})
        lib = "" if library is None else f", library {library_ms:.4f} ms"
        if graph:
            lib += f", from a CUDA graph {extra['graph_ms']:.4f} ms"
        print(f"[{phase}] {label}: equal, {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms by "
              f"{bound_by}: {bytes_moved} bytes {bytes_ms:.4f} ms, "
              f"{int(ops)} ops {ops_ms:.4f} ms)", flush=True)
        return k_out

    def matcher_cases(phase, path, tag, K, ne, nf, hash_bytes, max_dist,
                      top2, note=None, rows=B):
        """B1 then B2 at these knobs on the batch's first `rows` rows;
        returns B2's outputs."""
        win, ms_, lim_ = window[:rows], min_src[:rows], limit[:rows]
        key, fps = case(
            phase, path, f"prep_{tag}", "flate_prep",
            "flate_tpu/jx/match2.py:107",
            lambda: match2._prep(win, ne, hash_bytes, nf),
            lambda: match2._prep_plain(win, ne, hash_bytes, nf),
            nbytes(win) + rows * Wp * 4 * (1 + nf),    # u32 key + nf words
            # one op per byte hashed or gathered into a fingerprint
            rows * Wp * (4 * ((ne << nf) - ne if nf else 0) + hash_bytes),
            note=note, graph=True)
        skey, order = torch.sort(key, dim=1)
        # the key sort at B1's int32 keys, beside the same keys as int64
        # (the sort's width before B1 wrote int32)
        k64 = match2.key_u32(key)
        sorts = {"sort_ms": cuda_ms(lambda: torch.sort(key, dim=1), 20),
                 "sort_int64_ms": cuda_ms(lambda: torch.sort(k64, dim=1), 20)}
        if not torch.equal(match2.key_u32(skey), torch.sort(k64, dim=1)[0]):
            raise AssertionError(f"{tag}: the int32 key sort is not the u32 "
                                 f"order")
        cases[-1].update(sorts)
        del k64
        print(f"[{phase}] key sort {tag}: torch.sort of the int32 keys "
              f"{sorts['sort_ms']:.4f} ms (of the same keys as int64 "
              f"{sorts['sort_int64_ms']:.4f} ms)", flush=True)
        args = (skey, order, win, fps, ms_, lim_, W, K, max_dist, ne,
                hash_bytes, top2)
        # what the scan needs on this data: the candidates within K before
        # its end (another bucket, past max_dist, below min_src) in rows
        # that can match, and for a valid one the word compares up to and
        # including the first word that differs
        scan = {}
        match2._run_matcher_plain(*args, stats=scan)
        print(f"[{phase}] matcher_{tag}: K={K}, {ne} exact + {nf} "
              f"fingerprint words; the scan visits {scan['visits']} "
              f"candidates and compares {scan['compares']} words",
              flush=True)
        outs = rows * W * 4 * (2 if top2 else 1)     # u32 outputs
        # what the kernel reads: the sorted u32 keys, the window, min_src
        # and limit, and the fingerprint words; printed beside it, the
        # bound of reading ne + nf u32 words a position (the inputs of the
        # TPU kernel, and of this one before its redesign)
        words_ms = (rows * Wp * 4 * (1 + ne + nf) + outs) / HBM_BYTES_PER_S * 1e3
        extra = {}
        if tag == "l6":
            extra["ms_l2_flushed"] = cuda_ms_cold(
                lambda: match2._run_matcher(*args), 20)
        out = case(
            phase, path, f"matcher_{tag}", "flate_matcher",
            "flate_tpu/jx/match2.py:187",
            lambda: match2._run_matcher(*args),
            lambda: match2._run_matcher_plain(*args),
            rows * Wp * 4 + nbytes(win) + 8 * rows + outs + rows * Wp * 4 * nf,
            scan["visits"] + scan["compares"], note=note, extra=extra)
        print(f"[{phase}] matcher_{tag}: bound of reading {ne + nf} words "
              f"a position {words_ms:.4f} ms" + (
                  f"; L2 flushed before each launch "
                  f"{extra['ms_l2_flushed']:.4f} ms" if tag == "l6" else ""),
              flush=True)
        return out

    def better(l, d, l0, d0):
        upd = match2._score(l, d) > match2._score(l0, d0)
        return (torch.where(upd, l, l0).contiguous(),
                torch.where(upd, d, d0).contiguous())

    def walk_case(phase, path, label, step):
        """B9 on the rows of `step`; returns the mask."""
        (mask,) = case(
            phase, path, label, "flate_parse_walk",
            "flate_tpu/jx/parse.py:66",
            lambda: parse._parse_walk(step),
            lambda: parse._parse_walk_plain(step),
            5 * step.numel(),              # i32 steps in, u8 mask out
            lambda out: 2 * int(out[0].sum()))   # a load + an add a step
        print(f"[{phase}] {label}: {step.shape[0]} rows x {step.shape[1]}, "
              f"{int(mask.sum())} steps, longest row "
              f"{int(mask.sum(dim=1).max())}", flush=True)
        return mask

    def dp_options(m, grid_only):
        """The options of the squeeze's DP that the positions have: the
        literal, the full length (3 or more; not grid_only) and each grid
        length below the match's (at most it, grid_only)."""
        n = m.numel()
        if grid_only:
            return n + sum(int((m >= g).sum()) for g in squeeze.GRID)
        return n + int((m >= 3).sum()) + sum(
            int((m > g).sum()) for g in squeeze.GRID[:-1])

    for L in KERNEL_LEVELS:
        # the stages of encode_batch_packed, one kernel at a time
        lvl = pipeline2.level_params(L, S)
        phase, path = (3 if L in LEVELS else 7), ("encode", L)
        nw, cap, blk = lvl["nw"], 4 * lvl["nw"], lvl["blk"]
        both = "the K pass and the K3 pass of a batch" if lvl["K3"] else None
        (ld,) = matcher_cases(phase, path, f"l{L}", lvl["K"], nw, 0, 4,
                              32768, False, both)
        mlen0, mdist0 = ld >> 16, ld & 0xFFFF
        if lvl["K3"]:
            (ld3,) = matcher_cases(phase, path, f"k3_l{L}", lvl["K3"], 1, 0,
                                   3, 4096, False, both)
            mlen0, mdist0 = better(torch.clamp(ld3 >> 16, max=3),
                                   ld3 & 0xFFFF, mlen0, mdist0)
        rlen, rdist = case(
            phase, path, f"small_runs_l{L}", "flate_small_runs",
            "flate_tpu/jx/runs.py:85",
            lambda: runs.small_dist_runs(window, limit, min_src),
            lambda: runs._small_dist_runs_plain(window, limit, min_src),
            nbytes(window) + 2 * B * W * 4,
            sum(int(ln.sum()) for ln in        # one compare per run byte
                runs._run_lengths(window, limit, min_src)), graph=True)
        mlen0, mdist0 = better(rlen, rdist, mlen0, mdist0)
        (mlen,) = case(
            phase, path, f"extend_l{L}", "flate_extend",
            "flate_tpu/jx/runs.py:172",
            lambda: runs.extend_chains(mlen0, mdist0, limit, cap),
            lambda: runs._extend_chains_plain(mlen0, mdist0, limit, cap),
            nbytes(mlen0, mdist0) + B * W * 4,
            3 * B * W + 3 * int(((mlen0 == cap) & (mdist0 > 0)).sum()),
            graph=True)
        drop = (mlen == 3) & (mdist0 > 4096)
        mlen = torch.where(drop, 0, mlen)
        mdist = torch.where(drop, 0, mdist0)
        whole = match2.find_matches_fused(window, ctx_len, valid, K=lvl["K"],
                                          nw=nw, ctx=CTX, K3=lvl["K3"])
        if not (torch.equal(mlen, whole[0]) and torch.equal(mdist, whole[1])):
            raise AssertionError(f"level {L}: the stages do not give "
                                 f"find_matches_fused's matches")
        mlen, mdist = parse.truncate_matches(mlen, mdist, CTX, blk)
        take, step = parse.decide(mlen, mdist, lvl["lazy"], lvl["max_lazy"])
        # rows = parse blocks, as parse_blocks and the squeeze walk cut them
        mask = walk_case(
            phase, path, f"parse_walk_blocks_l{L}",
            step[:, CTX:].to(torch.int32).reshape(-1, blk).contiguous())
        m_r, d_r, take_r = mlen[:, CTX:], mdist[:, CTX:], take[:, CTX:]
        starts_r = mask.reshape(B, S)
        if lvl["squeeze"]:
            wt = window[:, CTX:]
            ll_bits, d_bits = squeeze.greedy_code_lengths(
                wt, m_r, d_r, starts_r, take_r, valid)
            dp_args = (wt, m_r, d_r, ll_bits, d_bits, blk,
                       squeeze.grid_only_default())
            case(phase, path, f"squeeze_dp_l{L}", "flate_squeeze_dp",
                 "flate_tpu/jx/squeeze.py:73",
                 lambda: squeeze._squeeze_dp_kernel(*dp_args),
                 lambda: squeeze._squeeze_dp_plain(*dp_args),
                 # byte, length and distance in, the chosen length out
                 nbytes(wt, m_r, d_r, ll_bits, d_bits) + B * S * 4,
                 # an add and a min for each option that a position has
                 2 * dp_options(m_r, dp_args[-1]),
                 graph=True)
            take_r, starts_r, m_r = pipeline2._squeeze_stage(
                window[:, CTX:], m_r, d_r, take_r, starts_r, valid, blk=blk)
        seg = encode2.seg_size(S, blk)
        vals, bits, _, _ = encode2.build_fields(
            window[:, CTX:], m_r, d_r, starts_r, take_r, valid, finals, S,
            seg)
        nwr = pipeline2._nwr(S, seg)
        # the whole pack_fields call (its offsets included), words as
        # (B, nwords) beside the plain version's cumsum + placement
        case(phase, path, f"pack_l{L}", "flate_pack",
             "flate_tpu/jx/pack.py:32",
             lambda: (lambda w, t: (w.reshape(B, -1), t))(
                 *pack.pack_fields(vals, bits, nwr)),
             lambda: pack._pack_plain(vals, bits, nwr * 128),
             # u32 values and widths in, the words out
             nbytes(vals, bits) + B * nwr * 128 * 4,
             3 * int((bits != 0).sum()),   # add, shift and OR per field
             graph=True)
        if L == 6:
            # rows = shards, as parse_walk cuts them: untruncated matches
            _, step = parse.decide(*whole, True, 32)
            walk_case(7, ("fp", "parse_walk"), "parse_walk_shards",
                      step[:, CTX:].to(torch.int32).contiguous())
        del ld, vals, bits, whole, mask, step

    # the fp/top-2 matcher (no level sets it) and the top-2 extension
    ne, nf = match2._split_words(8, True)
    ld, ld2 = matcher_cases(7, ("fp",), "fp", 48, ne, nf, 4, 32768, True)
    cands = (ld >> 16, ld & 0xFFFF, ld2 >> 16, ld2 & 0xFFFF)
    case(7, ("fp",), "extend2_fp", "flate_extend2",
         "flate_tpu/jx/runs.py:196",
         lambda: runs.extend_chains2(*cands, limit, 4 * ne),
         lambda: runs._extend_chains2_plain(*cands, limit, 4 * ne),
         nbytes(*cands) + 2 * B * W * 4,
         6 * B * W + 3 * sum(int(((l == 4 * ne) & (d > 0)).sum())
                             for l, d in (cands[:2], cands[2:])),
         graph=True)
    # B2 at K = 1024 with 20 exact words (rows staged with 65 words: the
    # halo's are built from the window), through find_matches_fused on the
    # batch's first 4 rows; no level sets it
    big = 4
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    match2.find_matches_fused(window[:big], ctx_len[:big], valid[:big],
                              K=1024, nw=20, ctx=CTX)
    torch.cuda.synchronize()
    launches[("match", "k1024")] = dict(_build.LAUNCHES)
    matcher_cases(7, ("match", "k1024"), "k1024_nw20", 1024, 20, 0, 4, 32768,
                  False, rows=big)
    del ld, ld2, cands, window, shards

    # ---- phase 4: the main path through the public entry point ----
    data32 = route_input("mixed32M")
    data8 = data32[:B * S]             # bench.py's 8 MiB mixed corpus
    text = route_input("text")         # bench.py's text corpus
    blobs = {}
    # B8 runs under find_matches_fused(fp=True) only, which no level sets;
    # the squeeze's DP at levels 2 and 4-9 only
    level_kernels = [k for k in _build.ENCODE_KERNELS if k != "flate_extend2"]
    unsqueezed = [k for k in level_kernels if k != "flate_squeeze_dp"]

    def need_launched(what, counts, names=level_kernels):
        for name in names:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"{what}: kernel {name} never launched "
                                     f"on the main path: {counts}")

    for L in LEVELS:
        api.gzip.compress(data8, level=L)            # warm-up (allocator)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.time()
        blob = api.gzip.compress(data32, level=L)
        secs = time.time() - t
        counts = dict(_build.LAUNCHES)
        need_launched(f"level {L}", counts, unsqueezed)
        launches[("encode", L)] = counts
        if zlib.decompress(blob, 31) != data32:
            raise AssertionError(f"level {L}: zlib round trip differs")
        check_route_pin(f"mixed32M-l{L}", blob, 4)
        gpu8 = api.gzip.compress(data8, level=L)
        cpu8 = api.gzip.compress(data8, level=L, device="cpu")
        if gpu8 != cpu8:
            raise AssertionError(f"level {L}: cuda bytes != cpu bytes "
                                 f"({len(gpu8)} vs {len(cpu8)})")
        ratios = {}
        for cname, cd, blob_c in (("mixed 32 MiB", data32, blob),
                                  ("mixed 8 MiB", data8, gpu8),
                                  ("text", text, None)):
            if blob_c is None:
                blob_c = api.gzip.compress(cd, level=L)
                if zlib.decompress(blob_c, 31) != cd:
                    raise AssertionError(f"level {L}: {cname} round trip")
                check_route_pin(f"text-l{L}", blob_c, 4)
            blobs[cname, L] = blob_c
            zl = len(zlib.compress(cd, L))
            ratios[cname] = (f"{len(blob_c)} bytes = {len(blob_c) / zl:.4f} "
                             f"of zlib -{L} ({zl})")
        print(f"[4] level {L}: 32 MiB mixed in {secs:.4f} s = "
              f"{len(data32) / secs / 1e9:.4f} GB/s; launches {counts}; "
              f"8 MiB cuda == cpu; round trips ok; 32 MiB and text == JAX "
              f"pins; size: {ratios}",
              flush=True)

    # ---- phase 5: the decode kernels against their plain versions ----
    hdr, meta = parse_header(Container.GZIP, blobs["text", 3])
    comp_lens, out_lens, _ = parse_index_extra(meta.extra)
    run, off = [], hdr
    for c_len, o_len in zip(comp_lens[:8], out_lens[:8]):
        sh = blobs["text", 3][off:off + int(c_len)]
        off += int(c_len)
        plan = inflate2.plan_shard(sh, int(o_len))
        if plan.kind != "coded":
            raise AssertionError("text shard is not one coded block")
        run.append((plan, sh))
    dargs = inflate2.pack_coded_run(run, b"", dev)
    word = inflate2._pass1(dargs[0], *dargs[3:9])
    dstart, dbits = dargs[2], 8 * dargs[1]
    DB, DN = word.shape
    G, J, NS = inflate2.LANE_G, inflate2.LANE_J, S + 128
    steps = {}
    inflate2._lane_walk_plain(word, dstart, dbits, G, J, steps)
    print(f"[5] decode batch: {DB} shards, C = {DN // 8}, N = {DN}, "
          f"NL = {DN // G}, G = {G}, J = {J}, NS = {NS}; lane walk steps "
          f"{steps}", flush=True)
    case(5, ("decode", "a3"), "lane_walk", "flate_lane_walk",
         "flate_tpu/jx/inflate2.py:399",
         lambda: inflate2._lane_walk(word, dstart, dbits, G=G, J=J),
         lambda: inflate2._lane_walk_plain(word, dstart, dbits, G, J),
         # words read once, the u8 mask and the u8 join flags written once
         4 * DN * DB + DN * DB + (DN // G) * DB + 8 * DB,
         steps["phase1_steps"] + steps["join_steps"], graph=True)
    lane_marks = most_marks(
        inflate2._lane_walk_plain(word, dstart, dbits, G, J)[0], G)
    wcounts = inflate2._walk(word, dstart, dbits, NS)[1]
    walked = int(wcounts.sum())
    print(f"[5] serial walk: {walked} symbols in {DB} rows, longest row "
          f"{int(wcounts.max())}; lane walk: most marks in one lane "
          f"{lane_marks}", flush=True)
    case(5, ("decode", "d"), "walk", "flate_walk",
         "flate_tpu/jx/inflate2.py:302",
         lambda: inflate2._walk(word, dstart, dbits, NS),
         lambda: inflate2._walk_plain(word, dstart, dbits, NS),
         # words read once, the symbol rows and the counts written once
         4 * DN * DB + 4 * NS * DB + 12 * DB,
         walked)                                 # one step per symbol
    del word, dargs
    # B6 on a chained-route row chunk, as the chained decode gives it
    cw, cstart, cbits = chained_chunk(api, inflate2, blobs["mixed 8 MiB", 1])
    csteps = {}
    cmask = inflate2._lane_walk_plain(cw, cstart, cbits, G, J, csteps)[0]
    cmarks = most_marks(cmask, G)
    case(5, ("decode", "b1"), "lane_walk_chained", "flate_lane_walk",
         "flate_tpu/jx/inflate2.py:399",
         lambda: inflate2._lane_walk(cw, cstart, cbits, G=G, J=J),
         lambda: inflate2._lane_walk_plain(cw, cstart, cbits, G, J),
         4 * cw.numel() + cw.numel() + (cw.shape[1] // G) * cw.shape[0]
         + 8 * cw.shape[0],
         csteps["phase1_steps"] + csteps["join_steps"], graph=True)
    print(f"[5] lane walk, chained-route row chunk: {cw.shape[0]} rows x "
          f"{cw.shape[1]}, {cw.shape[0] * cw.shape[1] // G} lanes; steps "
          f"{csteps}; most marks in one lane {cmarks}, chain floor "
          f"{cmarks * CHAIN_STEP_NS * 1e-6:.4f} ms at {CHAIN_STEP_NS} ns a "
          f"step; kernel {cases[-1]['ms']:.4f} ms, from a CUDA graph "
          f"{cases[-1]['graph_ms']:.4f} ms", flush=True)
    del cw, cmask

    # ---- phase 6: the decode path through the public entry point ----
    first8 = text[:8 * S]
    runs6 = [
        ("a1", "gzip", blobs["text", 1], text, {}),
        ("a3", "gzip", blobs["text", 3], text, {}),
        ("b3", "gzip", blobs["mixed 32 MiB", 3], data32, {}),
        ("b1", "gzip", blobs["mixed 8 MiB", 1], data8, {}),
        ("c", "zlib", zlib.compress(text, 9), text, {}),
        ("d", "gzip", api.gzip.compress(first8, level=3), first8,
         {"walk": "serial"}),
    ]
    api.gzip.decompress(runs6[-1][2])            # warm-up (allocator)
    for tag, ns, blob, want, kw in runs6:
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        inflate2.STATS.clear()
        t = time.time()
        got = getattr(api, ns).decompress(blob, **kw)
        secs = time.time() - t
        counts = dict(_build.LAUNCHES)
        stats = dict(inflate2.STATS)
        launches["decode", tag] = counts
        if got != want:
            raise AssertionError(f"decode {tag}: output differs from input")
        route = "chained" if stats.get("chained_members") else "indexed"
        nshards = -(-len(want) // S)
        need = "flate_walk" if tag == "d" else "flate_lane_walk"
        if counts.get(need, 0) <= 0:
            raise AssertionError(f"decode {tag}: {need} never launched: "
                                 f"{counts}")
        if tag in ("a1", "a3"):
            if stats.get("decode_batch2", 0) <= 0:
                raise AssertionError(f"decode {tag}: decode_batch2 never "
                                     f"ran: {stats}")
            if route != "indexed":
                raise AssertionError(f"decode {tag}: left the indexed "
                                     f"route: {stats}")
        if tag in ("b1", "b3") and stats.get("segmented_reroutes", 0) <= 0:
            raise AssertionError(f"decode {tag}: member was not re-routed: "
                                 f"{stats}")
        print(f"[6] decode {tag} ({ns}, {len(blob)} -> {len(want)} bytes"
              f"{', ' + str(kw) if kw else ''}): route {route}, chain heads "
              f"{stats.get('chain_heads', 0)}, "
              f"{secs:.4f} s = {len(want) / secs / 1e9:.4f} GB/s of output; "
              f"launches {counts}; {nshards} shards, host-decoded 0 (no "
              f"host decode on the path), batches walked again serially "
              f"{stats.get('serial_retries', 0)}; re-routes "
              f"{stats.get('segmented_reroutes', 0)}; stats {stats}",
              flush=True)

    # ---- phase 8: every other level through the public entry point ----
    def ratio(blob, data, L):
        zl = len(zlib.compress(data, L))
        if len(blob) > zl:
            raise AssertionError(f"level {L}: {len(blob)} bytes exceed "
                                 f"zlib's {zl}")
        return len(blob) / zl

    def batch_of(data):
        """The first B shards of `data` as encode_batch_packed takes them:
        (shards, ctx0, meta) on the card, no carried context, the last
        shard final."""
        shards = torch.frombuffer(bytearray(data[:B * S]), dtype=torch.uint8
                                  ).reshape(B, S).to(dev)
        meta = torch.zeros(3 * B + 1, dtype=torch.int32)
        meta[1:B] = CTX
        meta[B:2 * B] = S
        meta[3 * B - 1] = 1
        meta[3 * B] = B
        return (shards, torch.zeros(CTX, dtype=torch.uint8, device=dev),
                meta.to(dev))

    def code_length_flips(L):
        """Entries of the greedy pass's (ll_bits, d_bits) on the 8 MiB
        batch that differ between the card and the CPU, from the same
        parse: only the lengths from the histograms could differ."""
        lvl = pipeline2.level_params(L, S)
        shards, ctx0, meta = batch_of(data8)
        window = pipeline2._prime_windows(shards, ctx0, CTX)
        ml, md = match2.find_matches_fused(
            window, meta[:B], meta[B:2 * B], K=lvl["K"], nw=lvl["nw"],
            ctx=CTX, K3=lvl["K3"])
        ml, md = parse.truncate_matches(ml, md, CTX, lvl["blk"])
        take, _ = parse.decide(ml, md, lvl["lazy"], lvl["max_lazy"])
        starts = parse.parse_blocks(ml, md, start=CTX, lazy=lvl["lazy"],
                                    max_lazy=lvl["max_lazy"], blk=lvl["blk"])
        args = [x[:, CTX:] for x in (window, ml, md, starts, take)]
        on_card = squeeze.greedy_code_lengths(*args, meta[B:2 * B])
        on_cpu = squeeze.greedy_code_lengths(*(a.cpu() for a in args),
                                             meta[B:2 * B].cpu())
        return sum(int((a.cpu() != b).sum()) for a, b in zip(on_card, on_cpu))

    mixed1 = data32[:8 * S]
    for L, data in ((6, data32), (2, data8), (4, data8), (5, data8),
                    (7, data8), (8, data8), (9, data8)):
        api.gzip.compress(mixed1, level=L)           # warm-up (allocator)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.time()
        blob = api.gzip.compress(data, level=L)
        secs = time.time() - t
        counts = dict(_build.LAUNCHES)
        need_launched(f"level {L}", counts)
        launches[("encode", L)] = counts
        if zlib.decompress(blob, 31) != data:
            raise AssertionError(f"level {L}: zlib round trip differs")
        if L == 6:
            oneshot6 = secs
            blobs["mixed 32 MiB", 6] = blob
        line = (f"[8] level {L}: {len(data) >> 20} MiB mixed in {secs:.4f} s"
                f" = {len(data) / secs / 1e9:.4f} GB/s; launches {counts}; "
                f"zlib round trip ok; {len(blob)} bytes = "
                f"{ratio(blob, data, L):.4f} of zlib -{L}")
        if L in JAX_RATIOS:
            if L == 6:
                t = time.time()
                if api.gzip.decompress(blob) != data:
                    raise AssertionError("level 6: the port's own decode "
                                         "differs from the input")
                own6_secs = time.time() - t
                line += f"; own decode ok in {own6_secs:.4f} s"
            sized = {"text": api.gzip.compress(text, level=L),
                     "mixed 8 MiB": blob if data is data8
                     else api.gzip.compress(data8, level=L)}
            blobs["mixed 8 MiB", L] = sized["mixed 8 MiB"]
            check_route_pin(f"text-l{L}", sized["text"], 8)
            for cname, cdata in (("text", text), ("mixed 8 MiB", data8)):
                if zlib.decompress(sized[cname], 31) != cdata:
                    raise AssertionError(f"level {L}: {cname} round trip")
                line += (f"; {cname} {len(sized[cname])} bytes = "
                         f"{ratio(sized[cname], cdata, L):.4f} of zlib "
                         f"(JAX package {JAX_RATIOS[L][cname]})")
            # card against CPU: bytes
            t = time.time()
            cpu = api.gzip.compress(mixed1, level=L, device="cpu", batch=8)
            cpu_s = time.time() - t
            gpu = api.gzip.compress(mixed1, level=L, batch=8)
            line += (f"; 8 shards: cuda == cpu bytes {gpu == cpu} (cpu twin "
                     f"{cpu_s:.1f} s)")
            if gpu != cpu:
                raise AssertionError(f"level {L}: cuda bytes != cpu bytes")
        if pipeline2.level_params(L)["squeeze"]:
            flips = code_length_flips(L)
            line += (f"; ll_bits/d_bits entries of the 8 MiB batch that "
                     f"differ between card and CPU: {flips}")
            if flips:
                raise AssertionError(f"level {L}: {flips} greedy code "
                                     f"lengths differ between card and CPU")
        print(line, flush=True)

    prod_pins(api, pipeline2, graphs, Container, dev, data32)

    # the squeeze's rounded code lengths near every step, card against CPU
    ph, pt = length_step_pairs()
    rows = torch.from_numpy(np.stack([ph, pt - ph], 1).astype(np.int32))
    t = time.time()
    on_card = squeeze._entropy_code_lens(rows.to(dev))
    torch.cuda.synchronize()
    card_s = time.time() - t
    log2_lens = torch.round(squeeze._entropy_lens(rows.to(dev)))
    other = int((log2_lens != on_card)[:, 0].sum())
    on_card = on_card.cpu()
    differ = int((on_card != squeeze._entropy_code_lens(rows)).sum())
    print(f"[8] squeeze code lengths of {len(ph)} count pairs near a step "
          f"(totals up to {int(pt.max())}), one call: card == CPU on "
          f"{on_card.numel() - differ} of {on_card.numel()} lengths "
          f"({card_s:.4f} s on the card); a correctly rounded log2 gives "
          f"another length than the JAX pipeline's on {other} pairs",
          flush=True)
    if differ:
        raise AssertionError(f"squeeze code lengths: {differ} differ "
                             f"between card and CPU")

    def flip_shards(data, L):
        """Shards of data's level-L encode whose greedy histograms hold a
        count pair where a correctly rounded log2 rounds to another code
        length than the JAX pipeline's (squeeze._entropy_code_lens)."""
        real, hits = squeeze._entropy_code_lens, []

        def spy(h):
            lens = real(h)
            other = torch.round(squeeze._entropy_lens(h)).to(lens.dtype)
            hits.append((lens != other).any(dim=1))
            return lens

        squeeze._entropy_code_lens = spy
        try:
            api.gzip.compress(data, level=L)
        finally:
            squeeze._entropy_code_lens = real
        # a batch's calls: its literal/length, then its distance histograms
        return sum(int((a | b).sum()) for a, b in zip(hits[::2], hits[1::2]))

    text8 = text_corpus(B * S)
    hit = {L: (flip_shards(data32, L), flip_shards(text8, L))
           for L in range(1, 10) if pipeline2.level_params(L)["squeeze"]}
    print(f"[8] shards whose greedy histogram holds such a pair, by squeeze "
          f"level (of {len(data32) // S} shards of 32 MiB mixed, "
          f"{len(text8) // S} of 8 MiB text): "
          + ", ".join(f"level {L} {m} / {t}" for L, (m, t) in hit.items()),
          flush=True)

    # one batch through the fp/top-2 matcher to a stream
    _build.LAUNCHES.clear()
    t = time.time()
    shards, ctx0, meta = batch_of(data8)
    window = pipeline2._prime_windows(shards, ctx0, CTX)
    mlen, mdist = match2.find_matches_fused(
        window, meta[:B], meta[B:2 * B], K=48, nw=8, ctx=CTX, fp=True)
    walked = parse.parse_walk(mlen, mdist, start=CTX, lazy=True, max_lazy=32)
    launches[("fp", "parse_walk")] = dict(_build.LAUNCHES)  # the shard walk
    doubled = parse.parse_doubling(mlen, mdist, CTX, lazy=True, max_lazy=32)
    if not torch.equal(walked, doubled):
        raise AssertionError("fp: parse_walk != parse_doubling")
    mlen, mdist = parse.truncate_matches(mlen, mdist, CTX, 1024)
    take, _ = parse.decide(mlen, mdist, True, 32)
    starts = parse.parse_blocks(mlen, mdist, start=CTX, lazy=True,
                                max_lazy=32, blk=1024)
    seg = encode2.seg_size(S, 1024)
    vals, bits, _, _ = encode2.build_fields(
        window[:, CTX:], mlen[:, CTX:], mdist[:, CTX:], starts[:, CTX:],
        take[:, CTX:], meta[B:2 * B], meta[2 * B:3 * B], S, seg)
    words, tbits = pack.pack_fields(vals, bits, pipeline2._nwr(S, seg))
    buf, mo = pipeline2._compact_stage(words, tbits, shards, meta[B:2 * B],
                                       meta[3 * B])
    raw = buf[:int(mo[0])].cpu().numpy().tobytes()
    secs = time.time() - t
    counts = dict(_build.LAUNCHES)
    need_launched("fp batch", counts,
                  [k for k in _build.ENCODE_KERNELS if k != "flate_squeeze_dp"])
    launches[("fp",)] = counts
    if zlib.decompress(raw, -15) != data8:
        raise AssertionError("fp batch: zlib round trip differs")
    print(f"[8] fp=True batch (K=48, nw=8: 2 exact + 2 fingerprint words, "
          f"top-2 extension, cap 8): 8 MiB in {secs:.4f} s; launches "
          f"{counts}; parse_walk == parse_doubling ({int(walked.sum())} "
          f"token starts); zlib round trip ok; {len(raw)} raw bytes = "
          f"{len(raw) / len(zlib.compress(data8, 6)):.4f} of zlib -6",
          flush=True)

    # ---- phase 9: B10, the bitonic probe's network, full width ----
    # the level-6 payload of the first 8 MiB batch: B1's keys (hash<<18 |
    # pos, unique) and the 8 carry words of each position (the TPU sorts
    # them with the keys), padded from Wp to 2^18 with the sentinel key
    # 0xFFFFFFFF and operands equal to the position
    n10 = bitonic.R * bitonic.C
    shards = torch.frombuffer(bytearray(head[CTX:]), dtype=torch.uint8
                              ).reshape(B, S).to(dev)
    ctx0 = torch.frombuffer(bytearray(head[:CTX]), dtype=torch.uint8).to(dev)
    window = pipeline2._prime_windows(shards, ctx0, CTX)
    key6, _ = match2._prep(window, 8, 4)
    W = window.shape[1]
    Wp = key6.shape[1]
    words6 = to_i32(match2._window_words(
        window, torch.arange(Wp, device=dev).expand(B, Wp), 8, 4))
    k10 = torch.full((B, n10), -1, dtype=torch.int32, device=dev)
    k10[:, :Wp] = to_i32(match2.key_u32(key6))    # B1 stores u32 ^ 2^31
    pos = torch.arange(n10, dtype=torch.int32, device=dev).expand(B, n10)
    o10 = []
    for i in range(words6.shape[1]):
        o = pos.clone()
        o[:, :Wp] = words6[:, i]
        o10.append(o.view(torch.uint32).reshape(B, bitonic.R, bitonic.C))
    k10 = k10.view(torch.uint32).reshape(B, bitonic.R, bitonic.C)
    del key6, words6, window, shards, pos
    full = bitonic.bitonic_stages(n10)
    arrays = 1 + len(o10)
    plans = {name: bitonic.plan_passes(st, n10) for name, st in
             (("full", full), ("mix", bitonic.CALIBRATE_MIX))}
    print("[9] bitonic pass plans: " + "; ".join(
        f"{name} {len(plan)} passes ("
        + ", ".join(f"{kind} {len(run)}" for kind, run in plan) + ")"
        for name, plan in plans.items()), flush=True)

    def as_i32(outs):
        return tuple(x.view(torch.int32) for x in outs)

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    got = as_i32(bitonic.run(k10, o10, full))
    torch.cuda.synchronize()
    launches[("bitonic", "full")] = dict(_build.LAUNCHES)
    # the library call: torch.sort of the keys (int64: CUDA sorts no
    # uint32) and a gather per operand, inputs made before the timing
    k64 = k10.reshape(B, n10).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    o32 = [o.reshape(B, n10).view(torch.int32) for o in o10]

    def library_sort():
        s_, idx = torch.sort(k64, dim=1)
        return (s_, *[torch.gather(o, 1, idx) for o in o32])

    lib = library_sort()
    if int(lib[0][:, W - 1].max()) >= 0xFFFFFFFF:
        raise AssertionError("B10: a real key reached the sentinel")
    head_ok = torch.equal(got[0].reshape(B, n10)[:, :W].to(torch.int64)
                          & 0xFFFFFFFF, lib[0][:, :W]) and all(
        torch.equal(g.reshape(B, n10)[:, :W], x[:, :W])
        for g, x in zip(got[1:], lib[1:]))
    if not head_ok:
        raise AssertionError("B10: the first W positions differ from "
                             "torch.sort + gather")
    tail = got[1].reshape(B, n10)[:, W:].sort(dim=1).values
    dup = int((tail[:, 1:] == tail[:, :-1]).sum())
    print(f"[9] bitonic full network: {B} rows x {n10} (W = {W} real keys, "
          f"{n10 - W} sentinels), {arrays} arrays, {len(full)} substages; "
          f"launches {launches['bitonic', 'full']}; first W positions == "
          f"torch.sort + gather; operand entries of the sentinel tail "
          f"that are copies (equal keys duplicate): {dup}", flush=True)
    del lib, tail
    case(9, ("bitonic", "full"), "bitonic_full", "flate_bitonic",
         "tools/bitonic_probe.py:46",
         lambda: as_i32(bitonic.run(k10, o10, full)),
         lambda: as_i32(bitonic._run_plain(k10, o10, full)),
         arrays * 2 * 4 * B * n10,            # every u32 array in and out
         2 * len(full) * B * n10,              # compare + select a substage
         library=library_sort)
    del k10, o10, k64, o32, got
    # the probe's calibrate mix: 8 rows of random keys, operands key + i
    rng = np.random.default_rng(0)
    kc = rng.integers(0, 2**32, (8, bitonic.R, bitonic.C), dtype=np.uint32)
    kmix = torch.from_numpy(kc).to(dev)
    omix = [torch.from_numpy(kc + np.uint32(i)).to(dev)
            for i in range(arrays - 1)]
    mix = bitonic.CALIBRATE_MIX
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    bitonic.run(kmix, omix, mix)
    torch.cuda.synchronize()
    launches[("bitonic", "mix")] = dict(_build.LAUNCHES)
    case(9, ("bitonic", "mix"), "bitonic_calibrate_mix", "flate_bitonic",
         "tools/bitonic_probe.py:46",
         lambda: as_i32(bitonic.run(kmix, omix, mix)),
         lambda: as_i32(bitonic._run_plain(kmix, omix, mix)),
         arrays * 2 * 4 * 8 * n10, 2 * len(mix) * 8 * n10)
    per_sub = cases[-1]["ms"] / len(mix) / 8
    print(f"[9] calibrate mix: {len(mix)} substages x 8 rows "
          f"{cases[-1]['ms']:.4f} ms -> {per_sub * 1e3:.3f} us/substage/row "
          f"-> full sort est {per_sub * len(full) * B:.4f} ms ({len(full)} "
          f"substages x {B} rows); measured {cases[-2]['ms']:.4f} ms; "
          f"torch.sort + gather {cases[-2]['library_ms']:.4f} ms",
          flush=True)
    del kmix, omix

    # ---- phase 10: the streaming encoder through the public entry point ----
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t = time.time()
    sink = io.BytesIO()
    member, flushed = stream_writes(api.gzip.compressor(sink, level=6), sink,
                                    data32)
    secs = time.time() - t
    counts = dict(_build.LAUNCHES)
    need_launched("streaming level 6", counts)
    launches[("stream", 6)] = counts
    if zlib.decompressobj(31).decompress(flushed) != data32[:STREAM_CUT]:
        raise AssertionError("stream: the flushed prefix does not decode to "
                             "the first 11 MiB")
    if zlib.decompress(member, 31) != data32:
        raise AssertionError("stream: zlib round trip differs")
    check_route_pin("stream32M-l6-flushed", flushed, 10)
    check_route_pin("stream32M-l6", member, 10)
    print(f"[10] streaming gzip.compressor level 6: 32 MiB mixed in writes of "
          f"{STREAM_PIECE} bytes, flush at {STREAM_CUT}: {secs:.4f} s = "
          f"{len(data32) / secs / 1e9:.4f} GB/s (one-shot level 6, phase 8: "
          f"{oneshot6:.4f} s = {len(data32) / oneshot6 / 1e9:.4f} GB/s); "
          f"launches {counts}; flushed prefix {len(flushed)} bytes decodes "
          f"to the first 11 MiB; member {len(member)} bytes "
          f"({len(member) / len(zlib.compress(data32, 6)):.4f} of zlib -6) "
          f"decodes with zlib", flush=True)
    zd = text_corpus(32 * 1024)
    with_d = api.zlib.compress(route_input("text4"), dictionary=zd)
    without = api.zlib.compress(route_input("text4"))
    check_route_pin("fdict-l6", with_d, 10)
    check_route_pin("nodict-l6", without, 10)
    dobj = zlib.decompressobj(zdict=zd)
    if dobj.decompress(with_d) != zd * 4 or not dobj.eof:
        raise AssertionError("dictionary: zlib round trip differs")
    if len(with_d) >= len(without):
        raise AssertionError(f"dictionary: {len(with_d)} bytes, not smaller "
                             f"than {len(without)} without it")

    def split_encode(device):
        enc = pipeline2.DeviceEncoder(level=6, batch=8, device=device)
        raw = (enc.encode(mixed1[:3 * S + 17])
               + enc.encode(mixed1[3 * S + 17:], final=True))
        return raw, enc.comp_lens

    t = time.time()
    cpu = split_encode("cpu")
    cpu_s = time.time() - t
    gpu = split_encode(dev)
    if gpu != cpu:
        raise AssertionError("stream: split DeviceEncoder cuda bytes != cpu")
    if zlib.decompress(gpu[0], -15) != mixed1:
        raise AssertionError("stream: split DeviceEncoder round trip")
    print(f"[10] zlib.compress(32 KiB text x 4, dictionary=32 KiB text): "
          f"{len(with_d)} bytes (without: {len(without)}), decodes with "
          f"zdict; DeviceEncoder level 6, 8 shards in batches of 8, split at "
          f"3 x 128 KiB + 17: cuda == cpu bytes ({len(gpu[0])}, cpu twin "
          f"{cpu_s:.1f} s)", flush=True)

    # ---- phase 11: the fused path, one CUDA graph a batch ----
    staged6 = launches[("encode", 6)]            # phase 8: 4 batches
    graphs.clear()

    def fused(data, L, **kw):
        """compress_device2(fused=True) and the graph its last batch
        replayed, with the call's seconds."""
        t = time.time()
        out = pipeline2.compress_device2(data, level=L, fused=True, **kw)
        return out, next(reversed(graphs._GRAPHS.values())), time.time() - t

    def graph_line(g):
        return (f"capture {g.capture_s:.3f} s, instantiate "
                f"{g.instantiate_s:.3f} s, {g.nodes} nodes")

    _, g6, first_s = fused(data8, 6)             # captures 64 x 128 KiB
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    replays0 = g6.replays
    blob, _, secs = fused(data32, 6)
    counts = dict(_build.LAUNCHES)
    if blob != blobs["mixed 32 MiB", 6]:
        raise AssertionError("fused level 6: bytes differ from phase 8's")
    if zlib.decompress(blob, 31) != data32:
        raise AssertionError("fused level 6: zlib round trip differs")
    if g6.replays - replays0 != 4:
        raise AssertionError(f"fused level 6: {g6.replays - replays0} "
                             f"replays for 4 batches")
    per_batch = dict(g6.launches)
    if counts != staged6 or counts != {k: 4 * v for k, v in
                                       per_batch.items()}:
        raise AssertionError(f"fused level 6: launches {counts}, staged "
                             f"{staged6}, a replay {per_batch}")
    need_launched("fused level 6", counts)
    launches[("fused", 6)] = counts
    replay_ms = cuda_ms(g6.graph.replay, 5)
    print(f"[11] fused level 6 (one CUDA graph a 64 x 128 KiB batch): "
          f"{graph_line(g6)}; first call on 8 MiB {first_s:.3f} s; 32 MiB "
          f"mixed in {secs:.4f} s = {len(data32) / secs / 1e9:.4f} GB/s "
          f"(staged, phase 8: {oneshot6:.4f} s = "
          f"{len(data32) / oneshot6 / 1e9:.4f} GB/s); 4 batches, 2 in "
          f"flight, {g6.replays} replays in all; launches {counts} = 4 x a "
          f"replay's {per_batch} = phase 8's staged; one replay "
          f"{replay_ms:.3f} ms of device time (CUDA events over 5); bytes "
          f"== phase 8's level 6, zlib round trip ok", flush=True)
    for L in (1, 9):
        blob, g, first_s = fused(data8, L)
        if blob != blobs["mixed 8 MiB", L]:
            raise AssertionError(f"fused level {L}: bytes != staged bytes")
        _, _, secs = fused(data8, L)
        print(f"[11] fused level {L}: 8 MiB mixed, bytes == staged; "
              f"{graph_line(g)}; first call {first_s:.3f} s, then "
              f"{secs:.4f} s = {len(data8) / secs / 1e9:.4f} GB/s; a replay "
              f"launches {dict(g.launches)}; one replay "
              f"{cuda_ms(g.graph.replay, 3):.3f} ms of device time",
              flush=True)
    gpu, g, _ = fused(mixed1, 6, batch=8)
    t = time.time()
    cpu = pipeline2.compress_device2(mixed1, level=6, batch=8, fused=True,
                                     device="cpu")
    cpu_s = time.time() - t
    if gpu != cpu:
        raise AssertionError("fused level 6, 8 shards: cuda bytes != cpu")
    print(f"[11] fused level 6 on 8 shards in batches of 8: cuda == cpu "
          f"bytes ({len(gpu)}, cpu {cpu_s:.1f} s); {graph_line(g)}; "
          f"{len(graphs._GRAPHS)} graphs alive in one pool", flush=True)

    # ---- phase 12: the mesh encoder on one card ----
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from flate_tpu_torch.parallel import distributed, mesh2
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as td:
        torch.cuda.set_device(0)
        tdist.init_process_group(
            "nccl", store=tdist.FileStore(os.path.join(td, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("shards",))
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t = time.time()
            blob = mesh2.compress_mesh2(data8, mesh, level=6, per_device=B)
            secs = time.time() - t
            counts = dict(_build.LAUNCHES)
            need_launched("mesh level 6", counts)
            launches[("mesh", 6)] = counts
            if blob != blobs["mixed 8 MiB", 6]:
                raise AssertionError("mesh: bytes != compress_device2's")
            t = time.time()
            blob2, regions = distributed.compress_to_regions(
                data8, mesh, level=6, per_device=B)
            secs2 = time.time() - t
            pos = 0
            for off, ln in sorted(sp for r in regions for sp in r):
                if off != pos:
                    raise AssertionError(f"mesh regions: gap at {pos}")
                pos += ln
            if blob2 != blob or pos != len(blob):
                raise AssertionError("mesh regions do not tile the stream")
        finally:
            tdist.destroy_process_group()
    print(f"[12] compress_mesh2 on a one-rank NCCL mesh (FileStore), 8 MiB "
          f"mixed at level 6, 64 shards a rank: bytes == compress_device2"
          f"(batch=64) ({len(blob)}); first call {secs:.3f} s (the graph "
          f"captured: its warm-up and one replay, launches {counts}); "
          f"compress_to_regions {secs2:.3f} s, {len(regions[0])} span(s) "
          f"tile the stream; group destroyed.  The multi-rank exchange "
          f"(the context tail by send/recv, meta and bytes gathered in "
          f"rank order) is held only on the CPU (gloo, "
          f"tests/test_torch_mesh2.py) until a machine has several cards",
          flush=True)

    # ---- phase 13: the chunk-entry scanner (S1) on a foreign stream ----
    foreign = zlib.compress(data32, 6)
    body = foreign[2:]                  # the member body the decode scans
    sbuf = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    sbuf_cpu = sbuf.cpu()
    chunk = anyinflate.CHUNK_BYTES
    nchunks = -(-len(body) // chunk)
    zbuf = torch.zeros_like(sbuf)       # no offset passes the first test
    # The function is the list of offsets: the bound counts what this
    # run's data needs for it, the offsets up to each chunk's first header
    # with their parses (each to where its answer is settled) and the list
    # written.  The kernel stops near there too: the offsets it tested are
    # printed beside those the list needs.
    step = 8 * chunk
    lo, hi = scan._range(len(body), step, nchunks * step)
    nseg = -(-(hi - lo) // step)
    label = "scan_chunk_entries"

    def launch(b):
        return scan._scan_cuda(b, lo, step, hi, nseg)

    got = scan.chunk_entries(sbuf, chunk)
    st = {}
    t = time.time()
    want = scan._chunk_entries_plain(scan._prepare(sbuf_cpu), len(body),
                                     chunk, st)
    plain_ms = (time.time() - t) * 1e3
    if got != want or want != scan.chunk_entries(sbuf_cpu, chunk):
        raise AssertionError(f"{label}: kernel != plain ({got[:8]} vs "
                             f"{want[:8]})")
    state = launch(sbuf).cpu()
    tested = int(state[scan.STATE_TESTED])
    tiles = int(state[scan.STATE_TILES])
    if tested > (hi - lo) // 10:
        raise AssertionError(f"{label}: the kernel tested {tested} of "
                             f"{hi - lo} offsets, over a tenth")
    zstate = launch(zbuf).cpu()
    # the kernel with its state's fill (one call of _scan_cuda)
    ms = cuda_ms(lambda: launch(sbuf), 20)
    zero_ms = cuda_ms(lambda: launch(zbuf), 20)
    gms = graph_ms(lambda: launch(sbuf), 20)
    call_ms = host_ms(lambda: scan.chunk_entries(sbuf, chunk), 5)
    moved = scan.bytes_needed(st)
    ops = scan.ops_needed(st)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    needed = st.get("offsets", 0)
    cases.append(dict(
        name=label, entry="flate_scan_headers", path=("decode", "e"),
        route="cuda", source=_build.source_of("flate_scan_headers"),
        replaces="flate_tpu/native/fastinflate.c:1046 (host C; no "
                 "pallas_call)",
        max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, graph_ms=gms,
        call_ms=call_ms, zero_body_ms=zero_ms, offsets=hi - lo,
        offsets_tested=tested, offsets_needed=needed, found=len(got)))
    print(f"[13] {label}: {len(got)} offsets equal to the plain "
          f"version's ({got[:6]}...); the kernel tested {tested} of "
          f"the {hi - lo} offsets in {tiles} tiles, "
          f"{tested / max(needed, 1):.2f}x the {needed} the list needs "
          f"(all-zero body of the same length: "
          f"{int(zstate[scan.STATE_TESTED])}); kernel with its state's "
          f"fill {ms:.4f} ms (all-zero body {zero_ms:.4f} ms; from a "
          f"CUDA graph {gms:.4f} ms; the whole call with its fetch "
          f"{call_ms:.4f} ms); plain {plain_ms:.1f} ms on the host; "
          f"bound {bound_ms:.4f} ms by {bound_by} for what the list "
          f"needs ({moved} bytes {bytes_ms:.4f} ms, {ops} ops "
          f"{ops_ms:.4f} ms: {st}), {bound_ms / ms:.2%} of it",
          flush=True)
    # scan_headers, which no path calls: a launch a header
    h_lo, h_hi = scan._range(len(body), 0, 8 * (8 << 20))
    got = scan.scan_headers(sbuf, 0, 8 * (8 << 20), 64)
    st = {}
    want = scan._scan_plain(scan._prepare(sbuf_cpu), h_lo, h_hi, 64, st)
    if got != want:
        raise AssertionError(f"scan_headers: card != plain ({got[:8]} vs "
                             f"{want[:8]})")
    h_ms = host_ms(lambda: scan.scan_headers(sbuf, 0, 8 * (8 << 20), 64), 5)
    h_bound = max(scan.bytes_needed(st) / HBM_BYTES_PER_S,
                  scan.ops_needed(st) / INT_OPS_PER_S) * 1e3
    print(f"[13] scan_headers over the first 8 MiB, max_out 64: {len(got)} "
          f"offsets equal to the plain version's in {len(got) + 1} "
          f"launches at most; the whole call {h_ms:.4f} ms on the host "
          f"clock (bound {h_bound:.4f} ms for the {st.get('offsets', 0)} "
          f"offsets the list needs)", flush=True)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    inflate2.STATS.clear()
    t = time.time()
    got = api.zlib.decompress(foreign)
    secs = foreign_secs = time.time() - t
    counts = dict(_build.LAUNCHES)
    stats = dict(inflate2.STATS)
    launches["decode", "e"] = counts
    if got != data32:
        raise AssertionError("foreign stream: output differs from input")
    if counts.get("flate_scan_headers", 0) <= 0 or \
            counts.get("flate_lane_walk", 0) <= 0:
        raise AssertionError(f"foreign stream: kernels not launched: {counts}")
    if stats.get("chain_heads", 0) <= 1:
        raise AssertionError(f"foreign stream: one chain head: {stats}")
    inflate2.STATS.clear()
    t = time.time()
    one, end = anyinflate._decompress_member_any(
        foreign, 0, Container.ZLIB, True, dev, entries=[0])
    secs1 = time.time() - t
    stats1 = dict(inflate2.STATS)
    if one != data32 or end != len(foreign):
        raise AssertionError("foreign stream, one chain: output differs")
    # 128 KiB chunks: more chains than a round's row chunk holds at the
    # first span (MAX_POSITIONS / 2^19 positions = 64 rows)
    inflate2.STATS.clear()
    t = time.time()
    fine = anyinflate.decompress_device_any(foreign, Container.ZLIB,
                                            chunk_bytes=1 << 17)
    secs2 = time.time() - t
    stats2 = dict(inflate2.STATS)
    if fine != data32 or stats2.get("chain_heads", 0) <= 64:
        raise AssertionError(f"foreign stream, 128 KiB chunks: output "
                             f"differs or too few chains: {stats2}")
    print(f"[13] api.zlib.decompress of zlib.compress(32 MiB mixed, 6) "
          f"({len(foreign)} bytes, {nchunks} chunks of {chunk}): "
          f"{secs:.4f} s = {len(data32) / secs / 1e9:.4f} GB/s of output, "
          f"chain heads {stats['chain_heads']}, rounds "
          f"{stats.get('chained_rounds')}, launches {counts}; one chain "
          f"(entries=[0]) {secs1:.4f} s = {len(data32) / secs1 / 1e9:.4f} "
          f"GB/s, rounds {stats1.get('chained_rounds')}; 128 KiB chunks "
          f"{secs2:.4f} s = {len(data32) / secs2 / 1e9:.4f} GB/s, chain "
          f"heads {stats2['chain_heads']}, rounds "
          f"{stats2.get('chained_rounds')}; all equal the input",
          flush=True)

    # ---- phase 14: blocks past the chained route's old caps ----
    for name, container, blob, want in big_block_streams():
        ns = getattr(api, container.lower())
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        inflate2.STATS.clear()
        t = time.time()
        got = ns.decompress(blob)
        secs = time.time() - t
        counts = dict(_build.LAUNCHES)
        stats = dict(inflate2.STATS)
        if got != want:
            raise AssertionError(f"{name}: output differs from the input")
        if counts.get("flate_lane_walk", 0) + counts.get("flate_walk",
                                                         0) <= 0:
            raise AssertionError(f"{name}: no walk kernel launched: "
                                 f"{counts}")
        print(f"[14] {name} ({len(blob)} bytes, api.{container.lower()}."
              f"decompress on the card): {len(want)} bytes == input in "
              f"{secs:.4f} s = {len(want) / secs / 1e9:.4f} GB/s of output; "
              f"rows from blocks cut for the resolve "
              f"{stats.get('block_pieces', 0)}, rounds "
              f"{stats.get('chained_rounds')}, launches {counts}",
              flush=True)
    phase14_long(api, _build, inflate2, anyinflate)

    phase15(dev, api, _build, case, walk_case, launches)
    phase16(api, _build, inflate2, data32, foreign, foreign_secs,
            blobs["mixed 32 MiB", 6], own6_secs, blobs["mixed 8 MiB", 6],
            with_d, zd)
    phase17(api, _build, inflate2)

    for c in cases:
        c["launches"] = launches[c.pop("path")].get(c.pop("entry"), 0)
        if c["launches"] <= 0:
            raise AssertionError(f"{c['name']}: no launch on its path")
    print(card)
    print(json.dumps({"kernels": cases}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def prod_pins(api, pipeline2, graphs, Container, dev, data32) -> None:
    """Phase 8: every PROD_PINNED case encoded on the card staged, fused
    and through api.<ns>.compress; each sha256 must be the JAX package's
    pin and the member must decode with zlib."""
    t = time.time()
    for case, pin in PROD_PINNED.items():
        L, shard_len, ctx, batch, container, name = case
        data = {"mixed8M": data32[:B * S], "mixed32M": data32}.get(name) \
            or prod_input(name)
        kw = dict(shard_len=shard_len, ctx=ctx, batch=batch)
        ns = getattr(api, {"RAW": "flate", "ZLIB": "zlib",
                           "GZIP": "gzip"}[container])
        outs = {"staged": pipeline2.compress_device2(
                    data, L, Container[container], device=dev, **kw),
                "fused": pipeline2.compress_device2(
                    data, L, Container[container], device=dev, fused=True,
                    **kw),
                "api": ns.compress(data, level=L, **kw)}
        shas = {r: hashlib.sha256(o).hexdigest() for r, o in outs.items()}
        wbits = {"RAW": -15, "ZLIB": 15, "GZIP": 31}[container]
        print(f"[8] JAX pin {prod_id(case)} ({len(data)} B, shard_len "
              f"{shard_len}, ctx {ctx}): {len(outs['staged'])} bytes, sha256 "
              f"{shas['staged'][:12]} (pin {pin[:12]}); staged / fused / api "
              f"== pin: {[shas[r] == pin for r in outs]}", flush=True)
        if any(h != pin for h in shas.values()):
            raise AssertionError(f"{prod_id(case)}: sha256 {shas} != the JAX "
                                 f"package's {pin}")
        if zlib.decompress(outs["staged"], wbits) != data:
            raise AssertionError(f"{prod_id(case)}: zlib round trip")
    graphs.clear()
    print(f"[8] {len(PROD_PINNED)} cases at shard_len {S}, ctx {CTX} equal "
          f"the JAX package's sha256 staged, fused and through the public "
          f"entry point ({time.time() - t:.1f} s)", flush=True)


def phase14_long(api, _build, inflate2, anyinflate) -> None:
    """Phase 14's blocks longer than MAX_SPAN, decoded in continuation
    rows, each beside the same input cut into blocks of 2 MiB of input
    (at most 1.2 MB compressed, under MAX_SPAN)."""
    def decode(container, blob):
        ns = getattr(api, container.lower())
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        inflate2.STATS.clear()
        t = time.time()
        got = ns.decompress(blob)
        return (got, time.time() - t, dict(_build.LAUNCHES),
                dict(inflate2.STATS))

    t = time.time()
    streams = long_block_streams()
    print(f"[14] long blocks written by the port's host writer in "
          f"{time.time() - t:.1f} s", flush=True)
    for name, container, blob, want in streams:
        frame = 18 if container == "GZIP" else 6
        rows = -(-(len(blob) - frame) // anyinflate.MAX_SPAN)
        got, secs, counts, stats = decode(container, blob)
        if got != want:
            raise AssertionError(f"{name}: output differs from the input")
        walks = counts.get("flate_lane_walk", 0) + counts.get("flate_walk",
                                                              0)
        if walks <= 0:
            raise AssertionError(f"{name}: no walk kernel launched: "
                                 f"{counts}")
        if stats.get("continuation_rows", 0) < rows - 1:
            raise AssertionError(
                f"{name}: {stats.get('continuation_rows', 0)} continuation "
                f"rows, the block needs at least {rows - 1}")
        cut = member(container, host_blocks(
            want, 2 << 20, name.startswith("huffman")), want)
        got2, secs2, counts2, stats2 = decode(container, cut)
        if got2 != want:
            raise AssertionError(f"{name}, cut into blocks: output differs "
                                 f"from the input")
        print(f"[14] {name} (one block of {len(blob) - frame} bytes, "
              f"api.{container.lower()}.decompress on the card): "
              f"{len(want)} bytes == input in {secs:.4f} s = "
              f"{len(want) / secs / 1e9:.4f} GB/s of output; continuation "
              f"rows {stats.get('continuation_rows', 0)} (at least "
              f"{rows - 1}), rounds {stats.get('chained_rounds')}, chain "
              f"heads {stats.get('chain_heads')}, false heads "
              f"{stats.get('false_heads', 0)}, rows cut for the resolve "
              f"{stats.get('block_pieces', 0)}, launches {counts}; the same "
              f"input in blocks of 2 MiB of input ({len(cut)} bytes): "
              f"{secs2:.4f} s = {len(want) / secs2 / 1e9:.4f} GB/s, rounds "
              f"{stats2.get('chained_rounds')}, launches {counts2}",
              flush=True)
        windows = [api.Decompressor.WINDOW // 4]
        if name.startswith("huffman"):
            windows.insert(0, api.Decompressor.WINDOW)
        for w in windows:
            # stream_read holds the peak input to TRIM + w + FETCH
            out, ssecs, dstats, scounts, sstats = stream_read(
                api, _build, inflate2, container.lower(), blob, w)
            if out != want:
                raise AssertionError(f"{name}: {container.lower()}."
                                     f"decompressor's output at a {w}-byte "
                                     f"window differs from the input")
            conts = sstats.get("continuation_rows", 0)
            if conts < rows - 1:
                raise AssertionError(f"{name} at a {w}-byte window: {conts} "
                                     f"continuation rows, the block needs "
                                     f"at least {rows - 1}")
            bound = api.Decompressor.TRIM + w + api.Decompressor.FETCH
            print(f"[14] {name} through {container.lower()}.decompressor at "
                  f"a {w}-byte window: == input in {ssecs:.4f} s = "
                  f"{len(want) / ssecs / 1e9:.4f} GB/s, steps "
                  f"{dstats.get('steps')}, continuation rows {conts} (at "
                  f"least {rows - 1}), rounds "
                  f"{sstats.get('chained_rounds')}, peak input "
                  f"{dstats.get('input_peak')} B (bound TRIM + WINDOW + "
                  f"FETCH = {bound}), peak output held "
                  f"{dstats.get('output_peak')} B (bound OUT_CAP + read = "
                  f"{api.Decompressor.OUT_CAP + (1 << 20) + 17}), launches "
                  f"{scounts}",
                  flush=True)


def round1_stages_equal(r1, r1match, data: bytes, level: int) -> str:
    """Rows 0-1 of the round-1 pipeline's batch 1 (row 0 primed with 32
    KiB of context, min_src 0) through its stages on the card and on the
    CPU: find_matches_device (B3, B4), parse_walk (B9), the token arrays
    and histograms, and pack_tokens (B5) with the plans' code tables, each
    held to the plain run integer for integer."""
    from flate_tpu_torch.device import encode as r1enc
    from flate_tpu_torch.device import parse as r1parse

    knobs = r1.level_knobs(level)
    arr = np.frombuffer(data, np.uint8)
    shards = torch.from_numpy(arr[8 * S:10 * S].copy()).reshape(2, S)
    ctx0 = torch.from_numpy(arr[8 * S - CTX:8 * S].copy())
    win = r1.build_windows(shards, ctx0, ctx=CTX)
    ctx_lens = torch.full((2,), CTX, dtype=torch.int32)

    def stages(w, cl):
        mlen, mdist = r1match.find_matches_device(
            w, cl, K=knobs["K"], K3=knobs["K3"], min_len=3, ctx=CTX,
            nwords=knobs["nwords"])
        starts = r1parse.parse_walk(mlen, mdist, start=CTX,
                                    lazy=knobs["lazy"],
                                    max_lazy=knobs["max_lazy"])
        take, _ = r1parse.decide(mlen, mdist, knobs["lazy"],
                                 knobs["max_lazy"])
        tok = r1enc.compact_tokens(w[:, CTX:], mlen[:, CTX:],
                                   mdist[:, CTX:], starts[:, CTX:],
                                   take[:, CTX:])
        ll, dd = r1enc.histograms(tok)
        return {"mlen": mlen, "mdist": mdist, "starts": starts, "ll": ll,
                "dd": dd, **tok}, tok

    got, gtok = stages(win.cuda(), ctx_lens.cuda())
    want, wtok = stages(win, ctx_lens)
    for k in want:
        if not torch.equal(got[k].cpu(), want[k]):
            raise AssertionError(f"round-1 level {level}: {k} on the card "
                                 f"!= plain, batch 1 rows 0-1")
    hll, hdd = want["ll"].numpy(), want["dd"].numpy()
    plans = r1.plan_shards(hll, hdd, [arr[8 * S:9 * S], arr[9 * S:10 * S]])
    llp, dp = r1.code_tables(plans, 2)
    maxt = int(want["ntokens"].max())
    gw, gb = r1.phase2_bucketed(gtok, llp, dp, maxt)
    ww, wb = r1.phase2_bucketed(wtok, llp, dp, maxt)
    if not (torch.equal(gw.cpu(), ww) and torch.equal(gb.cpu(), wb)):
        raise AssertionError(f"round-1 level {level}: pack_tokens on the "
                             f"card != plain, batch 1 rows 0-1")
    matched = int((want["mlen"][:, CTX:] >= 3).sum())
    return (f"batch 1 rows 0-1 (row 0 with context): matches, starts, "
            f"tokens and packed words (B3, B4, B9, B5) == plain exactly "
            f"({matched} match positions, {int(wb.sum())} bits, kinds "
            f"{[p.kind for p in plans]})")


def first_calls(calls, fn) -> dict:
    """fn() with the arguments of the first call of each (module, name)
    in `calls` recorded, tensors cloned: {name: (args, kwargs)}."""
    seen, saved = {}, []
    for mod, name in calls:
        real = getattr(mod, name)
        saved.append((mod, name, real))

        def record(*args, _real=real, _name=name, **kw):
            if _name not in seen:
                seen[_name] = (tuple(a.clone() if isinstance(a, torch.Tensor)
                                     else a for a in args), kw)
            return _real(*args, **kw)
        setattr(mod, name, record)
    try:
        fn()
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    return seen


def round1_cases(r1, case, walk_case, data: bytes, level: int) -> None:
    """B3, B4, B9 and B5 at the round-1 shape (a batch of 8 x 128 KiB with
    32 KiB of context) against their plain versions, on the inputs that
    compress_device gives them in its first batch (recorded from a call
    on that batch), with their bounds as in phase 3."""
    from flate_tpu_torch.device import pack, parse, runs, to_i32
    seen = first_calls(
        ((runs, "small_dist_runs"), (runs, "extend_chains"),
         (parse, "_parse_walk"), (pack, "pack_fields")),
        lambda: r1.compress_device(data[:8 * S], level=level))
    path = ("round1", level)
    (window, limit, min_src), _ = seen["small_dist_runs"]
    B1, W1 = window.shape
    case(15, path, f"small_runs_r1_l{level}", "flate_small_runs",
         "flate_tpu/jx/runs.py:85",
         lambda: runs.small_dist_runs(window, limit, min_src),
         lambda: runs._small_dist_runs_plain(window, limit, min_src),
         nbytes(window) + 2 * B1 * W1 * 4,
         sum(int(ln.sum()) for ln in
             runs._run_lengths(window, limit, min_src)), graph=True)
    (mlen, mdist, limit), kw = seen["extend_chains"]
    cap = kw["cap"]
    case(15, path, f"extend_r1_l{level}", "flate_extend",
         "flate_tpu/jx/runs.py:172",
         lambda: runs.extend_chains(mlen, mdist, limit, cap),
         lambda: runs._extend_chains_plain(mlen, mdist, limit, cap),
         nbytes(mlen, mdist) + B1 * W1 * 4,
         3 * B1 * W1 + 3 * int(((mlen == cap) & (mdist > 0)).sum()),
         graph=True)
    (step,), _ = seen["_parse_walk"]
    walk_case(15, path, f"parse_walk_r1_l{level}", step)
    (vals, bits, nwr), _ = seen["pack_fields"]
    vals, bits = to_i32(vals), bits.to(torch.int32)
    case(15, path, f"pack_r1_l{level}", "flate_pack",
         "flate_tpu/jx/pack.py:32",
         lambda: (lambda w, t: (w.reshape(B1, -1), t))(
             *pack.pack_fields(vals, bits, nwr)),
         lambda: pack._pack_plain(vals, bits, nwr * 128),
         nbytes(vals, bits) + B1 * nwr * 128 * 4,
         3 * int((bits != 0).sum()), graph=True)


def phase15(dev, api, _build, case, walk_case, launches) -> None:
    """The round-1 encoder and its mesh on the card (docstring, 15)."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    from flate_tpu_torch.bitpack import BitSink
    from flate_tpu_torch.device import match as r1match
    from flate_tpu_torch.device import pipeline as r1
    from flate_tpu_torch.parallel import pigz

    need = ("flate_small_runs", "flate_extend", "flate_parse_walk",
            "flate_pack")
    data = route_input("r1")
    small = route_input("r1s")
    nbatch = -(-(len(data) // S) // 8)
    for level in (1, 6, 9):
        r1.compress_device(small, level=level)       # warm-up (allocator)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.time()
        blob = r1.compress_device(data, level=level)
        secs = time.time() - t
        counts = dict(_build.LAUNCHES)
        for name in need:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"round-1 level {level}: {name} never "
                                     f"launched: {counts}")
        launches[("round1", level)] = counts
        if zlib.decompress(blob, 31) != data:
            raise AssertionError(f"round-1 level {level}: zlib round trip")
        if api.gzip.decompress(blob) != data:
            raise AssertionError(f"round-1 level {level}: port decode")
        check_route_pin(f"round1-l{level}", blob, 15)
        ratio = len(blob) / len(zlib.compress(data, level))
        # the host tail encoder's share of the call, alone
        t = time.time()
        r1.write_tail(BitSink(), np.frombuffer(data, np.uint8),
                      len(data) // S, S, level)
        tail_s = time.time() - t
        t = time.time()
        cpu = r1.compress_device(small, level=level, batch=2, device="cpu")
        cpu_s = time.time() - t
        gpu = r1.compress_device(small, level=level)
        if gpu != cpu:
            raise AssertionError(f"round-1 level {level}: cuda != cpu bytes")
        check_route_pin(f"round1s-l{level}", gpu, 15)
        # batch 0 as the pipeline builds it, its phase1 and its main
        # table's candidate loop by CUDA events
        knobs = r1.level_knobs(level)
        shards = torch.frombuffer(bytearray(data[:8 * S]), dtype=torch.uint8
                                  ).reshape(8, S).to(dev)
        win = r1.build_windows(shards, torch.zeros(CTX, dtype=torch.uint8,
                                                   device=dev), ctx=CTX)
        ctx_lens = torch.full((8,), CTX, dtype=torch.int32, device=dev)
        ctx_lens[0] = 0
        h = r1match._hashes(win, 4)
        words = r1match._pack_words(win, knobs["nwords"])
        min_src = (CTX - ctx_lens).to(torch.int32)
        loop_ms = cuda_ms(lambda: r1match._candidate_best(
            h, words, knobs["K"], min_src, 3), 1)
        p1_ms = cuda_ms(lambda: r1.phase1(win, ctx_lens, ctx=CTX, **knobs), 1)
        held = round1_stages_equal(r1, r1match, data, level)
        per_batch = (secs - tail_s) / nbatch
        print(f"[15] round-1 compress_device level {level}, 8 MiB + 12345 "
              f"mixed, batch 8: {secs:.4f} s = "
              f"{len(data) / secs / 1e9:.4f} GB/s ({per_batch:.4f} s a batch "
              f"of 1 MiB over {nbatch} batches, besides the host tail's "
              f"{tail_s:.4f} s), {len(blob)} "
              f"bytes = {ratio:.4f} x zlib level {level}; launches {counts} "
              f"({counts['flate_parse_walk'] / nbatch:.0f} B9 a batch); "
              f"zlib and api.gzip.decompress round trips ok; batch 0 phase1 "
              f"{p1_ms:.3f} ms of device time, its candidate loop (K="
              f"{knobs['K']}, nw={knobs['nwords']}) {loop_ms:.3f} ms = "
              f"{loop_ms / 1e3 / per_batch:.2%} of a batch; cuda == cpu "
              f"bytes on 2 shards + 12345 (cpu {cpu_s:.1f} s); {held}",
              flush=True)
        if level == 6:
            round1_cases(r1, case, walk_case, data, level)

    mesh_data = route_input("pigz")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as td:
        torch.cuda.set_device(0)
        tdist.init_process_group(
            "nccl", store=tdist.FileStore(os.path.join(td, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("shards",))
            pigz.compress_mesh(small, mesh, level=6)      # warm-up
            torch.cuda.synchronize()
            t = time.time()
            blob = pigz.compress_mesh(mesh_data, mesh, level=6)
            secs = time.time() - t
        finally:
            tdist.destroy_process_group()
    if blob != r1.compress_device(mesh_data, level=6, batch=1):
        raise AssertionError("round-1 mesh: bytes != compress_device's")
    check_route_pin("pigz-l6", blob, 15)
    print(f"[15] pigz.compress_mesh on a one-rank NCCL mesh, 2 MiB + 12345 "
          f"at level 6: bytes == compress_device(batch=1) ({len(blob)}); "
          f"{secs:.4f} s = {len(mesh_data) / secs / 1e9:.4f} GB/s", flush=True)


def stream_read(api, _build, inflate2, container: str, blob: bytes,
                window: int, piece: int = (1 << 20) + 17, dictionary=None):
    """blob through api.<container>.decompressor(io.BytesIO(blob)) at a
    decode window of `window` bytes, read `piece` bytes at a time; launch
    counters and decode stats set to 0 just before, read just after.
    Raises past the input bound (TRIM + WINDOW + FETCH) or the output
    bound (OUT_CAP + piece).  Returns (output, seconds,
    Decompressor.stats, launches, stats)."""
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    inflate2.STATS.clear()
    t = time.time()
    d = getattr(api, container).decompressor(io.BytesIO(blob),
                                             dictionary=dictionary)
    d.WINDOW = window
    parts = []
    while chunk := d.read(piece):
        parts.append(chunk)
    secs = time.time() - t
    bound = d.TRIM + window + d.FETCH
    if d.stats["input_peak"] > bound:
        raise AssertionError(f"{container}.decompressor at a {window}-byte "
                             f"window: peak input {d.stats['input_peak']} "
                             f"bytes > TRIM + WINDOW + FETCH = {bound}")
    if d.stats["output_peak"] > d.OUT_CAP + piece:
        raise AssertionError(f"{container}.decompressor at a {window}-byte "
                             f"window: peak output held "
                             f"{d.stats['output_peak']} bytes > OUT_CAP + "
                             f"read = {d.OUT_CAP + piece}")
    return (b"".join(parts), secs, dict(d.stats), dict(_build.LAUNCHES),
            dict(inflate2.STATS))


class ChunkReader(io.RawIOBase):
    """A pipe-like reader: at most `max_chunk` bytes a read."""

    def __init__(self, data: bytes, max_chunk: int):
        self._data, self._pos, self._max = data, 0, max_chunk

    def read(self, n: int = -1) -> bytes:
        n = self._max if n < 0 or n > self._max else n
        chunk = self._data[self._pos:self._pos + n]
        self._pos += len(chunk)
        return chunk


class CheckWriter:
    """A writer that keeps nothing: it counts the bytes and takes their
    CRC-32, or (inflate=True, the bytes a gzip member) inflates them 64 KiB
    at a time and takes the CRC-32 of what comes out."""

    def __init__(self, inflate: bool = False):
        self.n, self.crc = 0, 0
        self._z = zlib.decompressobj(31) if inflate else None

    def _take(self, b: bytes) -> None:
        self.n += len(b)
        self.crc = zlib.crc32(b, self.crc)

    def write(self, b) -> None:
        if self._z is None:
            self._take(b)
            return
        b = bytes(b)
        while b:
            self._take(self._z.decompress(b, 1 << 16))
            b = self._z.unconsumed_tail


def reader_writer_memory(kind: str, size: int = 64 << 20) -> dict:
    """The JAX package's reader->writer memory bounds
    (tests/test_streaming_io.py test_compress_rss_bounded,
    test_decompress_rss_bounded) on the card, in this process: `size`
    bytes of the text corpus through
    api.gzip.compress(ChunkReader(data, 1 << 17), writer=, level=1)
    ("encode") or api.zlib.decompress(ChunkReader(zlib.compress(data, 1),
    1 << 17), writer=) ("decode"), or `size` zero bytes through
    api.zlib.decompress(ChunkReader(zlib.compress(zeros, 6), 1 << 17),
    writer=) ("zeros"), each after a warm-up through the same call (one
    full 8 MiB batch; a 16 MiB stream of the text).
    Returns the host's ru_maxrss growth over the run (KiB), the device's
    max_memory_allocated over the warm-up and over the run (peaks reset
    before each), seconds and GB/s of input (encode) or output (decode),
    and whether the bytes came out right (the encode's member inflated to
    the input's CRC-32, the decode's output the input's)."""
    import resource
    sys.path.insert(0, HERE)
    from flate_tpu_torch import api
    data = text_corpus(16 << 20 if kind == "zeros" else size)
    # what each call must give: (bytes, CRC-32), taken before any RSS is
    # read and without a copy of the input
    wants = [(n, zlib.crc32(memoryview(data)[:n])) for n in (
        B * S if kind == "encode" else 16 << 20, size)]
    if kind == "zeros":
        wants[1] = (size, zlib.crc32(bytes(size)))
    if kind == "encode":
        inputs = (data[:B * S], data)

        def run(x):
            w = CheckWriter(inflate=True)
            api.gzip.compress(ChunkReader(x, 1 << 17), writer=w, level=1)
            return w
    else:
        inputs = (zlib.compress(data[:16 << 20], 1),
                  zlib.compress(bytes(size), 6) if kind == "zeros"
                  else zlib.compress(data, 1))

        def run(x):
            w = CheckWriter()
            api.zlib.decompress(ChunkReader(x, 1 << 17), writer=w)
            return w
    out = {"kind": kind, "size": size, "stream": len(inputs[1])}
    for tag, x, want in zip(("warm", "run"), inputs, wants):
        torch.cuda.synchronize()
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        w = run(x)
        torch.cuda.synchronize()
        out[f"{tag}_secs"] = time.time() - t
        out[f"{tag}_peak"] = torch.cuda.max_memory_allocated()
        out[f"{tag}_rss_growth_kib"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss - rss0
        out[f"{tag}_ok"] = (w.n, w.crc) == want
    out["gbps"] = size / out["run_secs"] / 1e9
    out["window"] = api.Decompressor.WINDOW
    return out


RSS_GROWTH_KIB = 24 * 1024       # tests/test_streaming_io.py's bound


def memory_child(kind: str) -> dict:
    """reader_writer_memory(kind) in a process of its own, with the bounds
    checked: host RSS growth under RSS_GROWTH_KIB and the run's device
    peak at most the warm-up's + WINDOW; raises AssertionError past
    either, or when the bytes are wrong.  A shell forks the process: one
    exec'd from this one would start from this process's ru_maxrss (Linux
    keeps it across exec), which the check's own memory never passes."""
    r = subprocess.run(["/bin/sh", "-c", '"$@"; exit $?', "sh",
                        sys.executable, os.path.join(HERE, "chip_smoke.py"),
                        "--memory", kind], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"memory check {kind}: exit {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    if not (res["warm_ok"] and res["run_ok"]):
        raise AssertionError(f"memory check {kind}: wrong bytes: {res}")
    if res["run_rss_growth_kib"] >= RSS_GROWTH_KIB:
        raise AssertionError(f"memory check {kind}: host RSS grew "
                             f"{res['run_rss_growth_kib']} KiB >= "
                             f"{RSS_GROWTH_KIB}: {res}")
    if res["run_peak"] > res["warm_peak"] + res["window"]:
        raise AssertionError(f"memory check {kind}: device peak "
                             f"{res['run_peak']} B > the warm-up's "
                             f"{res['warm_peak']} + WINDOW: {res}")
    return res


def run_cli(main, data: bytes, argv) -> int:
    """main(argv) with `data` as its standard input, in this process."""
    saved = sys.stdin
    sys.stdin = type("Stdin", (), {"buffer": io.BytesIO(data)})()
    try:
        return main(argv)
    finally:
        sys.stdin = saved


def phase16(api, _build, inflate2, data32, foreign, foreign_secs, member6,
            own6_secs, member8, fdict_member, zd) -> None:
    """The rest of the decode API on the card: the streaming Decompressor,
    concatenated members of both routes, dictionaries, the too-far-back
    streams, the huffman and store modes, the two CLIs and the metrics."""
    from flate_tpu_torch import errors, metrics
    from flate_tpu_torch.cli import decompress_cli, roundtrip_cli
    window = api.Decompressor.WINDOW
    for name, container, blob, oneshot, windows in (
            ("zlib.compress(32 MiB mixed, 6)", "zlib", foreign, foreign_secs,
             (window, window // 4, window * 4)),
            ("phase 8's level-6 gzip member (FLT1)", "gzip", member6,
             own6_secs, (window, window // 4))):
        for w in windows:
            got, secs, dstats, counts, stats = stream_read(
                api, _build, inflate2, container, blob, w)
            if got != data32:
                raise AssertionError(f"stream {name}, window {w}: output "
                                     f"differs from the input")
            if container == "zlib":
                for k in ("flate_scan_headers", "flate_lane_walk",
                          "flate_walk"):
                    if counts.get(k, 0) <= 0:
                        raise AssertionError(f"stream {name}: {k} not "
                                             f"launched: {counts}")
            elif stats.get("false_heads", 0) or \
                    counts.get("flate_scan_headers", 0):
                raise AssertionError(f"stream {name}: a chain head off the "
                                     f"chain, or a scan: {stats} {counts}")
            steps = dstats["steps"]
            bound = api.Decompressor.TRIM + w + api.Decompressor.FETCH
            print(f"[16] {container}.decompressor(io.BytesIO({name}, "
                  f"{len(blob)} bytes)) at a {w}-byte window, reads of "
                  f"(1 << 20) + 17: == input in {secs:.4f} s = "
                  f"{len(data32) / secs / 1e9:.4f} GB/s (one-shot "
                  f"{oneshot:.4f} s = {len(data32) / oneshot / 1e9:.4f} "
                  f"GB/s); {steps} steps, chain heads a step "
                  f"{stats.get('chain_heads', 0) / steps:.2f}, rounds a step "
                  f"{stats.get('chained_rounds', 0) / steps:.2f}, false "
                  f"heads {stats.get('false_heads', 0)}; peak input "
                  f"{dstats['input_peak']} bytes (bound TRIM + WINDOW + "
                  f"FETCH = {bound}), peak output held "
                  f"{dstats['output_peak']} bytes (bound OUT_CAP + read = "
                  f"{api.Decompressor.OUT_CAP + (1 << 20) + 17}); launches S1 "
                  f"{counts.get('flate_scan_headers', 0)}, B6 "
                  f"{counts.get('flate_lane_walk', 0)}, B7 "
                  f"{counts.get('flate_walk', 0)} ({counts}); stats {stats}",
                  flush=True)

    metrics.reset()
    metrics.enable()
    other = text_corpus(3 << 20)
    two = member8 + gzip.compress(other, 6)
    t = time.time()
    if api.gzip.decompress(two) != data32[:B * S] + other:
        raise AssertionError("indexed + foreign gzip members: output differs")
    secs = time.time() - t
    routes = [r["op"] for r in metrics.records() if r["op"].startswith(
        "device.")]
    if routes != ["device.decompress_indexed", "device.decompress_any"]:
        raise AssertionError(f"indexed + foreign members: routes {routes}")
    print(f"[16] gzip.decompress(phase 8's 8 MiB level-6 member + "
          f"gzip.compress(3 MiB text)) in {secs:.4f} s: member routes "
          f"{routes}", flush=True)

    d32 = text_corpus(32 * 1024)
    c = zlib.compressobj(6, zdict=d32)
    zb = c.compress(data32[:B * S]) + c.flush()
    t = time.time()
    ok = (api.zlib.decompress(fdict_member, dictionary=zd) == zd * 4
          and api.zlib.decompress(zb, dictionary=d32) == data32[:B * S])
    secs = time.time() - t
    got, ssecs, dstats, counts, _ = stream_read(
        api, _build, inflate2, "zlib", zb, window, dictionary=d32)
    if not ok or got != data32[:B * S]:
        raise AssertionError("dictionary members: output differs")
    print(f"[16] phase 10's FDICT member and zlib.compressobj(6, zdict=32 "
          f"KiB text) over 8 MiB mixed ({len(zb)} bytes) decoded with "
          f"dictionary=: == input in {secs:.4f} s; the 8 MiB through the "
          f"Decompressor {ssecs:.4f} s, {dstats['steps']} steps, launches "
          f"{counts}", flush=True)

    for container, blob in too_far_streams():
        ns = api.flate if container == "RAW" else api.zlib
        try:
            ns.decompress(blob)
        except errors.InvalidMatch as e:
            print(f"[16] {container} stream of a match before its start "
                  f"({blob.hex()}): InvalidMatch ({e})", flush=True)
        else:
            raise AssertionError(f"{container} too far back: no error")

    data8 = data32[:B * S]
    for mode in ("huffman", "store"):
        sub = getattr(api.gzip, mode)
        t = time.time()
        blob = sub.compress(data8)
        csecs = time.time() - t
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.time()
        got = api.gzip.decompress(blob)
        dsecs = time.time() - t
        if got != data8 or zlib.decompress(blob, 31) != data8:
            raise AssertionError(f"{mode}: 8 MiB round trip differs")
        print(f"[16] gzip.{mode}.compress(8 MiB mixed) on the host: "
              f"{len(blob)} bytes in {csecs:.4f} s; gzip.decompress on the "
              f"card {dsecs:.4f} s = {len(data8) / dsecs / 1e9:.4f} GB/s, "
              f"launches {dict(_build.LAUNCHES)}; zlib agrees", flush=True)

    small = text_corpus(100_000)
    raw = zlib.compress(small, 6)[2:-4]
    codes = {
        "roundtrip_cli (100,000 bytes text)":
            (run_cli(roundtrip_cli.main, small, []), 0),
        "decompress_cli (its raw level-6 stream)":
            (run_cli(decompress_cli.main, raw, []), 0),
        "decompress_cli (cut 9 bytes short)":
            (run_cli(decompress_cli.main, raw[:-9], []), 1),
        "decompress_cli (a match before the start)":
            (run_cli(decompress_cli.main, too_far_streams()[0][1], []), 1),
    }
    for what, (rc, want) in codes.items():
        if rc != want:
            raise AssertionError(f"{what}: exit {rc}, expected {want}")
    print(f"[16] CLIs on the card, exit codes: "
          f"{ {k: v[0] for k, v in codes.items()} }", flush=True)
    print(f"[16] metrics.summary() of phase 16 after the streams: "
          f"{json.dumps(metrics.summary())}", flush=True)
    metrics.disable()
    metrics.reset()

    for kind in ("encode", "decode", "zeros"):
        r = memory_child(kind)
        what = ("gzip.compress(ChunkReader(64 MiB text, 1 << 17), writer=, "
                "level=1)" if kind == "encode" else
                f"zlib.decompress(ChunkReader(zlib.compress(64 MiB "
                f"{'text, 1' if kind == 'decode' else 'of zeros, 6'}) "
                f"= {r['stream']} B, 1 << 17), writer=)")
        warm = "one 8 MiB batch" if kind == "encode" else \
            "the 16 MiB stream"
        print(f"[16] reader -> writer memory, {what} in a process of its "
              f"own: == input in {r['run_secs']:.4f} s = {r['gbps']:.4f} "
              f"GB/s of {'input' if kind == 'encode' else 'output'}; host "
              f"ru_maxrss growth {r['run_rss_growth_kib']} KiB (bound < "
              f"{RSS_GROWTH_KIB}); device peak {r['run_peak']} B beside "
              f"{warm}'s {r['warm_peak']} B (bound that + WINDOW = "
              f"{r['warm_peak'] + r['window']}; warm-up "
              f"{r['warm_secs']:.4f} s, its RSS growth "
              f"{r['warm_rss_growth_kib']} KiB)", flush=True)


def phase17(api, _build, inflate2, device: str = "cuda") -> None:
    """Malformed streams on the card: every verdict of the one-shot and the
    streaming decode on the card (a decoded stream or an error class) must
    equal the table's, the construction's or the port's own on the CPU; a
    mismatch raises."""
    from flate_tpu_torch.cli import decompress_cli
    names = {"RAW": "flate", "ZLIB": "zlib", "GZIP": "gzip"}
    t0 = time.time()
    # the port's own seed members, made on the card before the counters
    # are set to 0, and on the CPU: the same bytes
    own = {c: own_member(c, device) for c in names}
    for c in names:
        cpu = own_member(c, "cpu")
        print(f"[17] own {c} member at shard_len 2048, ctx 1024, batch 2: "
              f"{device} {len(own[c])} B sha256 "
              f"{hashlib.sha256(own[c]).hexdigest()}, cpu {len(cpu)} B "
              f"sha256 {hashlib.sha256(cpu).hexdigest()}", flush=True)
        if own[c] != cpu:
            raise AssertionError(f"phase 17: the own {c} member made on "
                                 f"{device} differs from the CPU's")
    sets = [(c, m) for c, n in (("RAW", 300), ("ZLIB", 100), ("GZIP", 100))
            for m in mutants(fuzz_seeds(c, own[c]), n)]
    nthreads = torch.get_num_threads()
    torch.set_num_threads(1)         # the CPU twins: many tiny tensor ops
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    inflate2.STATS.clear()
    checked, bad = 0, []

    def decode(container, data, device):
        ns = getattr(api, names[container])
        one = verdict(lambda: ns.decompress(data, device=device))
        streamed = verdict(lambda: ns.decompressor(
            io.BytesIO(data), device=device).read_all())
        return one, streamed

    def check(what, got, want):
        nonlocal checked
        checked += 1
        if got != want:
            bad.append(f"{what}: {got[1] or len(got[0])} != "
                       f"{want[1] or len(want[0])}")

    try:
        for name, expect, cls in FUZZ_CASES:
            data, expect = fuzz_case(name, expect)
            want = (expect, cls)
            one, streamed = decode("RAW", data, device)
            check(f"corpus {name} one-shot", one, want)
            check(f"corpus {name} streamed", streamed, want)
        for name, container, data, expect in pinned_malformed():
            want = (expect, None) if isinstance(expect, bytes) \
                else (None, expect)
            one, streamed = decode(container, data, device)
            check(f"pinned {name} one-shot", one, want)
            check(f"pinned {name} streamed", streamed, want)
        accepted = 0
        for i, (container, data) in enumerate(sets):
            one, streamed = decode(container, data, device)
            cpu_one, cpu_streamed = decode(container, data, "cpu")
            check(f"{container} mutation {i} one-shot", one, cpu_one)
            check(f"{container} mutation {i} streamed", streamed,
                  cpu_streamed)
            if container == "GZIP":
                check(f"GZIP mutation {i} one-shot serial walk", verdict(
                    lambda: api.gzip.decompress(data, device=device,
                                                walk="serial")),
                    cpu_one)
            ref = python_accepts(container, data)
            if ref is not None:
                accepted += 1
                check(f"{container} mutation {i} against CPython", one,
                      (ref, None))
        big_secs = time.time()
        large = large_malformed_streams()
        for name, container, data, cls in large:
            one, streamed = decode(container, data, device)
            check(f"large {name} one-shot", one, (None, cls))
            check(f"large {name} streamed", streamed, (None, cls))
            if python_accepts(container, data) is not None:
                bad.append(f"large {name}: CPython accepts it")
        big_secs = time.time() - big_secs
        codes = {}
        with contextlib.redirect_stdout(io.StringIO()):
            for name, expect, cls in FUZZ_CASES:
                rc = run_cli(decompress_cli.main, fuzz_case(name, expect)[0],
                             ["--device", device])
                codes[rc] = codes.get(rc, 0) + 1
                check(f"decompress_cli {name}", (None, rc),
                      (None, 1 if cls else 0))
    finally:
        torch.set_num_threads(nthreads)
    counts = dict(_build.LAUNCHES)
    stats = dict(inflate2.STATS)
    secs = time.time() - t0
    print(f"[17] malformed streams on the card: {checked} verdicts (the 40 "
          f"corpus cases and {len(pinned_malformed())} pinned streams "
          f"one-shot and streamed against their table; {len(sets)} "
          f"mutations (300 raw, 100 zlib, 100 gzip) one-shot and streamed "
          f"against the port's CPU verdicts, gzip also with walk='serial', "
          f"{accepted} that CPython accepts against its bytes; "
          f"{len(large)} streams of 3 MiB of input in {big_secs:.4f} s; "
          f"decompress_cli exit codes "
          f"{codes}), mismatches {len(bad)}; launches S1 "
          f"{counts.get('flate_scan_headers', 0)}, B6 "
          f"{counts.get('flate_lane_walk', 0)}, B7 "
          f"{counts.get('flate_walk', 0)}; re-routed members "
          f"{stats.get('segmented_reroutes', 0)}; {secs:.4f} s", flush=True)
    if bad:
        raise AssertionError(f"phase 17: {len(bad)} mismatches: {bad[:20]}")
    for k in ("flate_scan_headers", "flate_lane_walk", "flate_walk"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"phase 17: {k} not launched: {counts}")


def python_accepts(container: str, data: bytes):
    """CPython's output where its zlib (raw, zlib: the whole input one
    stream) or gzip module accepts `data`, else None."""
    try:
        if container == "GZIP":
            return gzip.decompress(data)
        d = zlib.decompressobj(-15 if container == "RAW" else 15)
        out = d.decompress(data)
    except (OSError, EOFError, zlib.error):
        return None
    return out if d.eof and not d.unused_data else None


if __name__ == "__main__":
    if sys.argv[1:2] == ["--memory"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: torch.cuda.is_available() is False")
        print(json.dumps(reader_writer_memory(sys.argv[2])))
        sys.exit(0)
    sys.exit(main())
