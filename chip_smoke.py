"""Chip smoke of the PyTorch/CUDA port (flate_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each:
  1. the card: `nvidia-smi --query-gpu=name,power.limit` (needs CUDA);
  2. the kernel build (nvcc, sm_90a, one compiler per source, all started
     together) and its seconds;
  3. for levels 1 and 3, each encode kernel (B1-B5) against its plain
     PyTorch version on the card, at the main path's full-width shapes
     (64 shards of 128 KiB with 32 KiB context) and that level's knobs, on
     one 8 MiB batch of bench.py's mixed corpus: exact equality, kernel and
     plain times, and the bound (bytes over the memory rate or integer
     operations over the int32 issue rate, whichever is larger);
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
     launches, batches walked again serially and re-routes.
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
LEVELS = (1, 3)


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
    """Mean device time of fn() over reps launches after one warm-up."""
    fn()
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
    from flate_tpu_torch.device import pack, pipeline2, runs
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
             ops, reps=20, plain_reps=2):
        """entry: the C entry point; path: the main-path run whose launch
        count the case reports; bytes_moved: what the function must move
        at its own widths (u32 keys, words and field values), each input
        read once and each output written once; ops: the integer
        operations this run's data needs (a lower bound)."""
        k_out = kernel()
        p_out = plain()
        torch.cuda.synchronize()
        err = 0
        for a, b in zip(k_out, p_out):
            if a.shape != b.shape:
                raise AssertionError(f"{label}: shape {a.shape} vs {b.shape}")
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max().item()))
        if err != 0:
            raise AssertionError(f"{label}: kernel != plain "
                                 f"(max abs err {err})")
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
        print(f"[{phase}] {label}: equal, {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}: "
              f"{bytes_moved} bytes {bytes_ms:.4f} ms, {int(ops)} ops "
              f"{ops_ms:.4f} ms)", flush=True)
        return k_out

    for L in LEVELS:
        lvl = pipeline2.level_params(L, S)
        nw, K, cap = lvl["nw"], lvl["K"], 4 * lvl["nw"]
        key, words = case(
            3, ("encode", L), f"prep_l{L}", "flate_prep",
            "flate_tpu/jx/match2.py:107",
            lambda: match2._prep(window, nw, 4),
            lambda: match2._prep_plain(window, nw, 4),
            nbytes(window) + B * Wp * 4 * (1 + nw),    # u32 key + nw words
            B * Wp * (4 * nw + 4))     # one op per byte gathered/hashed
        skey, order = torch.sort(key, dim=1)
        # candidates the scan visits: same bucket, nearest first, up to K
        bucket = skey >> match2.POS_BITS
        same = skey != match2.SENTINEL
        visits = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(1, K + 1):
            same = same & torch.nn.functional.pad(
                bucket[:, k:] == bucket[:, :-k], (k, 0))
            visits += same.sum()
        (ld,) = case(
            3, ("encode", L), f"matcher_l{L}", "flate_matcher",
            "flate_tpu/jx/match2.py:187",
            lambda: (match2._run_matcher(skey, order, words, min_src, limit,
                                         W, K, 32768),),
            lambda: (match2._run_matcher_plain(skey, order, words, min_src,
                                               limit, W, K, 32768),),
            B * Wp * 4 * (1 + nw) + B * W * 4,  # sorted u32 keys + words in
            visits.item() * (nw + 1))      # bucket test + word compares
        rlen, rdist = case(
            3, ("encode", L), f"small_runs_l{L}", "flate_small_runs",
            "flate_tpu/jx/runs.py:85",
            lambda: runs.small_dist_runs(window, limit, min_src),
            lambda: runs._small_dist_runs_plain(window, limit, min_src),
            nbytes(window) + 2 * B * W * 4,
            sum(int(ln.sum()) for ln in        # one compare per run byte
                runs._run_lengths(window, limit, min_src)))
        mlen0, mdist0 = ld >> 16, ld & 0xFFFF
        upd = match2._score(rlen, rdist) > match2._score(mlen0, mdist0)
        mlen0 = torch.where(upd, rlen, mlen0).contiguous()
        mdist0 = torch.where(upd, rdist, mdist0).contiguous()
        (mlen,) = case(
            3, ("encode", L), f"extend_l{L}", "flate_extend",
            "flate_tpu/jx/runs.py:172",
            lambda: (runs.extend_chains(mlen0, mdist0, limit, cap),),
            lambda: (runs._extend_chains_plain(mlen0, mdist0, limit, cap),),
            nbytes(mlen0, mdist0) + B * W * 4,
            3 * B * W + 3 * int(((mlen0 == cap) & (mdist0 > 0)).sum()))
        drop = (mlen == 3) & (mdist0 > 4096)
        mlen = torch.where(drop, 0, mlen)
        mdist = torch.where(drop, 0, mdist0)
        mlen, mdist = parse.truncate_matches(mlen, mdist, CTX, lvl["blk"])
        take, _ = parse.decide(mlen, mdist, lvl["lazy"], lvl["max_lazy"])
        starts = parse.parse_blocks(mlen, mdist, start=CTX, lazy=lvl["lazy"],
                                    max_lazy=lvl["max_lazy"], blk=lvl["blk"])
        seg = encode2.seg_size(S, lvl["blk"])
        vals, bits, _, _ = encode2.build_fields(
            window[:, CTX:], mlen[:, CTX:], mdist[:, CTX:], starts[:, CTX:],
            take[:, CTX:], valid, finals, S, seg)
        bits = bits.to(torch.int32)
        incl = torch.cumsum(bits, dim=1, dtype=torch.int32)
        off = (incl - bits).contiguous()
        nwords = pipeline2._nwr(S, seg) * 128
        case(3, ("encode", L), f"pack_l{L}", "flate_pack",
             "flate_tpu/jx/pack.py:32",
             lambda: (pack._place(vals, off, nwords),),
             lambda: (pack._place_plain(vals, off, nwords),),
             vals.numel() * 4 + nbytes(off) + B * nwords * 4,  # u32 values
             2 * int((vals != 0).sum()))   # shift + atomic OR per field
        del key, words, skey, order, ld, vals, off
    del window, shards

    # ---- phase 4: the main path through the public entry point ----
    data32 = mixed_corpus(4 * B * S)
    data8 = data32[:B * S]             # bench.py's 8 MiB mixed corpus
    text = text_corpus(3_359_630)      # bench.py's text corpus
    launches = {}
    blobs = {}
    for L in LEVELS:
        api.gzip.compress(data8, level=L)            # warm-up (allocator)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t = time.time()
        blob = api.gzip.compress(data32, level=L)
        secs = time.time() - t
        counts = dict(_build.LAUNCHES)
        for name in _build.ENCODE_KERNELS:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"level {L}: kernel {name} never "
                                     f"launched on the main path: {counts}")
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
