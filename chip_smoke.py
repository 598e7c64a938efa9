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
     data needs over the int32 issue rate, whichever is larger);
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
     port's own pass 1: exact equality, times and bounds as in phase 3;
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
     rows = shards (64 x 131072, the parse_walk entry point);
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
     parse_doubling on the same matches.
Then, on lines of their own: the card's name and power limit, the kernel
JSON, and last `{"ok": true, "device": {...}}`.  Any failure exits
non-zero without the last line.  Imports nothing of JAX or flate_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from flate_tpu_torch import _build, api
    from flate_tpu_torch.containers import Container, parse_header
    from flate_tpu_torch.device import encode2, inflate2, match2, parse
    from flate_tpu_torch.device import pack, pipeline2, runs, squeeze
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

    def case(phase, path, label, entry, replaces, kernel, plain, bytes_moved,
             ops, reps=20, plain_reps=1, note=None):
        """entry: the C entry point; path: the main-path run whose launch
        count the case reports; bytes_moved: what the function must move
        at its own widths (u32 keys, words and field values), each input
        read once and each output written once; ops: the integer
        operations this run's data needs (a lower bound), or a function of
        the kernel's outputs that gives them; note: what else the launch
        count of this entry on that path covers.  The run that is compared
        is the warm-up of the timed ones."""
        def outputs(r):
            return r if isinstance(r, tuple) else (r,)

        k_out, p_out = outputs(kernel()), outputs(plain())
        err = 0
        for a, b in zip(k_out, p_out, strict=True):
            if a.shape != b.shape:
                raise AssertionError(f"{label}: shape {a.shape} vs {b.shape}")
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max().item()))
        if err != 0:
            raise AssertionError(f"{label}: kernel != plain "
                                 f"(max abs err {err})")
        if callable(ops):
            ops = ops(k_out)
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, plain_reps)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = float(ops) / INT_OPS_PER_S * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        bound_ms = max(bytes_ms, ops_ms)
        cases.append(dict(name=label, entry=entry, path=path,
                          route="cuda", source=_build.source_of(entry),
                          replaces=replaces,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None))
        if note:
            cases[-1]["launches_cover"] = note
        print(f"[{phase}] {label}: equal, {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}: "
              f"{bytes_moved} bytes {bytes_ms:.4f} ms, {int(ops)} ops "
              f"{ops_ms:.4f} ms)", flush=True)
        return k_out

    def matcher_cases(phase, path, tag, K, ne, nf, hash_bytes, max_dist,
                      top2, note=None):
        """B1 then B2 at these knobs; returns B2's outputs."""
        nc = ne + nf
        key, words = case(
            phase, path, f"prep_{tag}", "flate_prep",
            "flate_tpu/jx/match2.py:107",
            lambda: match2._prep(window, ne, hash_bytes, nf),
            lambda: match2._prep_plain(window, ne, hash_bytes, nf),
            nbytes(window) + B * Wp * 4 * (1 + nc),    # u32 key + nc words
            # one op per byte gathered into a word or hashed
            B * Wp * ((4 * ne << nf) + hash_bytes), note=note)
        skey, order = torch.sort(key, dim=1)
        args = (skey, order, words, min_src, limit, W, K, max_dist, nf, top2)
        # what the scan needs on this data: a bucket test per same-bucket
        # candidate within K, and for a valid one the word compares up to
        # and including the first word that differs
        scan = {}
        match2._run_matcher_plain(*args, stats=scan)
        print(f"[{phase}] matcher_{tag}: K={K}, {ne} exact + {nf} "
              f"fingerprint words; the scan visits {scan['visits']} "
              f"candidates and compares {scan['compares']} words",
              flush=True)
        return case(
            phase, path, f"matcher_{tag}", "flate_matcher",
            "flate_tpu/jx/match2.py:187",
            lambda: match2._run_matcher(*args),
            lambda: match2._run_matcher_plain(*args),
            # sorted u32 keys + words in, one or two u32 outputs
            B * Wp * 4 * (1 + nc) + B * W * 4 * (2 if top2 else 1),
            scan["visits"] + scan["compares"], note=note)

    def better(l, d, l0, d0):
        upd = match2._score(l, d) > match2._score(l0, d0)
        return (torch.where(upd, l, l0).contiguous(),
                torch.where(upd, d, d0).contiguous())

    def walk_case(phase, path, label, step, reps=20):
        """B9 on the rows of `step`; returns the mask."""
        (mask,) = case(
            phase, path, label, "flate_parse_walk",
            "flate_tpu/jx/parse.py:66",
            lambda: parse._parse_walk(step),
            lambda: parse._parse_walk_plain(step),
            5 * step.numel(),              # i32 steps in, u8 mask out
            lambda out: 2 * int(out[0].sum()),   # a load + an add a step
            reps=reps)
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
                runs._run_lengths(window, limit, min_src)))
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
        bits = bits.to(torch.int32)
        incl = torch.cumsum(bits, dim=1, dtype=torch.int32)
        off = (incl - bits).contiguous()
        nwords = pipeline2._nwr(S, seg) * 128
        case(phase, path, f"pack_l{L}", "flate_pack",
             "flate_tpu/jx/pack.py:32",
             lambda: pack._place(vals, off, nwords),
             lambda: pack._place_plain(vals, off, nwords),
             vals.numel() * 4 + nbytes(off) + B * nwords * 4,  # u32 values
             2 * int((vals != 0).sum()))   # shift + atomic OR per field
        if L == 6:
            # rows = shards, as parse_walk cuts them: untruncated matches
            _, step = parse.decide(*whole, True, 32)
            walk_case(7, ("fp", "parse_walk"), "parse_walk_shards",
                      step[:, CTX:].to(torch.int32).contiguous(), reps=3)
        del ld, vals, off, whole, mask, step

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
    del ld, ld2, cands, window, shards

    # ---- phase 4: the main path through the public entry point ----
    data32 = mixed_corpus(4 * B * S)
    data8 = data32[:B * S]             # bench.py's 8 MiB mixed corpus
    text = text_corpus(3_359_630)      # bench.py's text corpus
    launches = {}
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
         # words read once, the u8 mask and the joined flags written once
         4 * DN * DB + DN * DB + 4 * (DN // G) * DB + 8 * DB,
         steps["phase1_steps"] + steps["join_steps"])
    walked = int(inflate2._walk(word, dstart, dbits, NS)[1].sum())
    print(f"[5] serial walk: {walked} symbols in {DB} rows", flush=True)
    case(5, ("decode", "d"), "walk", "flate_walk",
         "flate_tpu/jx/inflate2.py:302",
         lambda: inflate2._walk(word, dstart, dbits, NS),
         lambda: inflate2._walk_plain(word, dstart, dbits, NS),
         # words read once, the symbol rows and the counts written once
         4 * DN * DB + 4 * NS * DB + 12 * DB,
         walked, reps=3, plain_reps=1)           # one step per symbol
    del word, dargs

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
