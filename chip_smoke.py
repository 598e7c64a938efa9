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
     and B5 (the whole pack_fields call, its offsets included) also
     replayed from a CUDA graph (graph_ms, the device alone), and a line
     each for torch.sort of B1's int32 keys beside the same keys as
     int64;
  4. the main path: flate_tpu_torch.api.gzip.compress of 32 MiB of the
     mixed corpus at levels 1 and 3 with the launch counters reset just
     before each run and read just after; the output must decode with zlib,
     the 8 MiB mixed input must equal the port's own device="cpu" bytes,
     and every kernel must have launched.  Size against zlib is printed
     for the mixed corpus (32 and 8 MiB) and bench.py's text corpus;
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
     from CPython's zlib at level 9 (unindexed, one chain from bit 0),
     (d) the first 8 text shards with walk="serial".  Each output must
     equal its input; the launch counters are reset before and read after
     each run, and each run prints its route, seconds, GB/s of output,
     launches, batches walked again serially and re-routes;
  7. (phase 3's loop, run right after it on its batch) B1-B5 at level
     6's and level 9's knobs (K=48, nw=8; K=160, nw=16 with the 3-byte K3
     pass; extension caps 32 and 64; pack after the squeeze, level 9 with
     4096-byte parse blocks), B1 with fingerprint words and B2 ranking by
     them with both outputs (K=48, nw=8, fp=True), B8 (top-2 chain
     extension) on those outputs, and B9 (parse walk) three ways: rows =
     level 6's parse blocks (8192 x 1024), rows = level 9's (2048 x 4096),
     rows = shards (64 x 131072, the parse_walk entry point); and B1/B2 at
     K = 1024 with 20 exact words (rows staged with 65 words, the halo's
     built from the window) on the batch's first 4 rows, whose launches
     are counted around find_matches_fused at those knobs.  B2 at level
     6 is also timed with the L2 flushed before each launch, and every B2
     case prints, beside its own bound, the bound of reading ne + nf words
     a position as the TPU kernel's inputs are laid out;
  8. the main path: api.gzip.compress at level 6 of 32 MiB mixed, decoded
     by zlib and by the port's own gzip.decompress; levels 2, 4, 5, 7, 8, 9
     on 8 MiB; sizes against zlib at the same level (must be <= 1.0), with
     the text and 8 MiB mixed ratios at levels 6 and 9 beside the JAX
     package's (BENCH_r05.json: sizes, a property of the bytes); CUDA
     bytes against the port's CPU bytes at levels 6 and 9 on 8 shards,
     with the count of greedy code lengths (ll_bits, d_bits: rounded
     float32 -log2) that differ between card and CPU; and one batch
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
     it; a split DeviceEncoder at level 6 on 8 shards in batches of 8 gives
     the same bytes on the card and the CPU.
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
Then, on lines of their own: the card's name and power limit, the kernel
JSON (every number in it measured in this run, or the bound computed from
this run's inputs), and last `{"ok": true, "device": {...}}`.  Any failure
exits non-zero without the last line.  Imports nothing of JAX or flate_tpu.
About 140 s on an H100 (the kernel build ~5 s, the CPU twins of phases 8
and 10 ~30-55 s, the plain versions' host loops ~25 s).
"""

from __future__ import annotations

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


def text_corpus(size: int) -> bytes:
    """RFC 1951's text repeated to `size` bytes (bench.py's text corpus)."""
    path = os.path.join(HERE, "tests", "data", "rfc1951.txt")
    with open(path, "rb") as fh:
        t = fh.read()
    return (t * (size // len(t) + 1))[:size]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from flate_tpu_torch import _build, api
    from flate_tpu_torch.containers import Container, parse_header
    from flate_tpu_torch.device import bitonic, encode2, inflate2, match2
    from flate_tpu_torch.device import graphs, pack, parse, pipeline2, runs
    from flate_tpu_torch.device import squeeze
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
            3 * B * W + 3 * int(((mlen0 == cap) & (mdist0 > 0)).sum()))
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
                             for l, d in (cands[:2], cands[2:])))
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
    data32 = mixed_corpus(4 * B * S)
    data8 = data32[:B * S]             # bench.py's 8 MiB mixed corpus
    text = text_corpus(3_359_630)      # bench.py's text corpus
    blobs = {}
    # B8 runs under find_matches_fused(fp=True) only, which no level sets
    level_kernels = [k for k in _build.ENCODE_KERNELS if k != "flate_extend2"]

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
        need_launched(f"level {L}", counts)
        launches[("encode", L)] = counts
        if zlib.decompress(blob, 31) != data32:
            raise AssertionError(f"level {L}: zlib round trip differs")
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
            blobs[cname, L] = blob_c
            zl = len(zlib.compress(cd, L))
            ratios[cname] = (f"{len(blob_c)} bytes = {len(blob_c) / zl:.4f} "
                             f"of zlib -{L} ({zl})")
        print(f"[4] level {L}: 32 MiB mixed in {secs:.4f} s = "
              f"{len(data32) / secs / 1e9:.4f} GB/s; launches {counts}; "
              f"8 MiB cuda == cpu; round trips ok; size: {ratios}",
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
              f"{', ' + str(kw) if kw else ''}): route {route}, "
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
        parse: only the float32 -log2 and its rounding can differ."""
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
                line += f"; own decode ok in {time.time() - t:.4f} s"
            sized = {"text": api.gzip.compress(text, level=L),
                     "mixed 8 MiB": blob if data is data8
                     else api.gzip.compress(data8, level=L)}
            blobs["mixed 8 MiB", L] = sized["mixed 8 MiB"]
            for cname, cdata in (("text", text), ("mixed 8 MiB", data8)):
                if zlib.decompress(sized[cname], 31) != cdata:
                    raise AssertionError(f"level {L}: {cname} round trip")
                line += (f"; {cname} {len(sized[cname])} bytes = "
                         f"{ratio(sized[cname], cdata, L):.4f} of zlib "
                         f"(JAX package {JAX_RATIOS[L][cname]})")
            # card against CPU: bytes, and the rounded -log2 code lengths
            t = time.time()
            cpu = api.gzip.compress(mixed1, level=L, device="cpu", batch=8)
            cpu_s = time.time() - t
            gpu = api.gzip.compress(mixed1, level=L, batch=8)
            flips = code_length_flips(L)
            line += (f"; 8 shards: cuda == cpu bytes {gpu == cpu} (cpu twin "
                     f"{cpu_s:.1f} s), ll_bits/d_bits entries of the 8 MiB "
                     f"batch that differ between card and CPU: {flips}")
            if gpu != cpu:
                if flips == 0:
                    raise AssertionError(f"level {L}: cuda bytes != cpu "
                                         f"bytes with equal code lengths")
                if zlib.decompress(gpu, 31) != mixed1:
                    raise AssertionError(f"level {L}: 8-shard round trip")
        print(line, flush=True)

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
    need_launched("fp batch", counts, _build.ENCODE_KERNELS)
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
    cut, piece = 11 << 20, (3 << 20) + 17
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t = time.time()
    sink = io.BytesIO()
    c = api.gzip.compressor(sink, level=6)
    at, flushed = 0, None
    while at < len(data32):
        end = min(at + piece, len(data32))
        if flushed is None and end >= cut:
            end = cut
        c.write(data32[at:end])
        at = end
        if flushed is None and at == cut:
            c.flush()
            flushed = sink.getvalue()
    c.finish()
    secs = time.time() - t
    counts = dict(_build.LAUNCHES)
    need_launched("streaming level 6", counts)
    launches[("stream", 6)] = counts
    member = sink.getvalue()
    if zlib.decompressobj(31).decompress(flushed) != data32[:cut]:
        raise AssertionError("stream: the flushed prefix does not decode to "
                             "the first 11 MiB")
    if zlib.decompress(member, 31) != data32:
        raise AssertionError("stream: zlib round trip differs")
    print(f"[10] streaming gzip.compressor level 6: 32 MiB mixed in writes of "
          f"{piece} bytes, flush at {cut}: {secs:.4f} s = "
          f"{len(data32) / secs / 1e9:.4f} GB/s (one-shot level 6, phase 8: "
          f"{oneshot6:.4f} s = {len(data32) / oneshot6 / 1e9:.4f} GB/s); "
          f"launches {counts}; flushed prefix {len(flushed)} bytes decodes "
          f"to the first 11 MiB; member {len(member)} bytes "
          f"({len(member) / len(zlib.compress(data32, 6)):.4f} of zlib -6) "
          f"decodes with zlib", flush=True)
    zd = text_corpus(32 * 1024)
    with_d = api.zlib.compress(zd * 4, dictionary=zd)
    without = api.zlib.compress(zd * 4)
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


if __name__ == "__main__":
    sys.exit(main())
