"""Where the time of kernels B2 (matcher) and B10 (bitonic network) goes.

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
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import B, CTX, S, cuda_ms, mixed_corpus, smi  # noqa: E402
from flate_tpu_torch.device import bitonic, match2, pipeline2  # noqa: E402


def timed(fn, reps: int) -> float:
    fn()
    return cuda_ms(fn, reps)


def matcher(reps: int) -> dict:
    dev = torch.device("cuda")
    head = mixed_corpus(CTX + B * S)
    ctx0 = torch.frombuffer(bytearray(head[:CTX]), dtype=torch.uint8).to(dev)
    shards = torch.frombuffer(bytearray(head[CTX:]), dtype=torch.uint8
                              ).reshape(B, S).to(dev)
    window = pipeline2._prime_windows(shards, ctx0, CTX)
    W = window.shape[1]
    min_src = torch.zeros(B, dtype=torch.int32, device=dev)
    limit = torch.full((B,), CTX + S, dtype=torch.int32, device=dev)
    limit[-1] -= 12345
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = smi()
    print(card, flush=True)
    res = {"card": card, **matcher(args.reps), **network(args.reps)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
