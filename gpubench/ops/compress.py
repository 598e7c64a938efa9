"""One-shot compress: `<container>.compress(data, level, shard_len, ctx,
batch)` on each pool input in turn; the answer is the member.

Checked once the window has closed: the plain reference proves each
input's distinct members, at most SAMPLE of them drawn from the seed
(bytes_wrong, framing_errors), which proves every call that returned the
same bytes; and a member is at most as long as zlib's at the
configuration's level (size_vs_zlib, the limit the configuration states).  The control encodes at the
configuration's `control_level` instead, which the size guarantee has to
catch."""

from __future__ import annotations

import multiprocessing
import os
import random
import sys
import zlib

from ..reference.member import check_member
from . import namespace

# distinct members of one input proven by the reference, at most (a
# deterministic encoder gives one a window)
SAMPLE = 3


def prepare(prog, cfg, mix, inputs, device, control):
    ns = namespace(prog, cfg)
    level = cfg["control_level"] if control else cfg["level"]

    def encode(data):
        return ns.compress(data, level=level, shard_len=cfg["shard_len"],
                           ctx=cfg["ctx"], batch=cfg["encode_batch"],
                           device=device)
    return {"encode": encode, "inputs": inputs}


def call(state, k):
    return state["encode"](state["inputs"][k])


def sizes(state, k, answer):
    return len(state["inputs"][k]), len(answer)


def after_window(state):
    return {}


def check(cfg, mix, inputs, calls, after, seed):
    failed = sum(c.error is not None for c in calls)
    # the distinct members of each input, and a sample of them drawn from
    # the seed for the reference
    distinct: dict = {}
    for c in calls:
        if c.error is None:
            distinct.setdefault(c.k, {}).setdefault(c.answer, c.answer)
    rng = random.Random(seed)
    jobs = []
    for k, members in sorted(distinct.items()):
        members = sorted(members, key=len)
        jobs += [(k, m) for m in rng.sample(members,
                                            min(SAMPLE, len(members)))]
    print(f"reference: {len(jobs)} of "
          f"{sum(len(m) for m in distinct.values())} distinct members "
          f"sampled", file=sys.stderr, flush=True)
    wrong = framing = 0
    ratio = 0.0
    workers = max(1, min(8, os.cpu_count() or 1) - 1)
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(workers)
    try:
        zl = {k: pool.apply_async(_zlib_len, (inputs[k], cfg["level"]))
              for k in distinct}
        for k, member in jobs:
            res = check_member(member, inputs[k], cfg["container"],
                               cfg.get("index", False),
                               mapper=lambda f, it: pool.imap(f, it, 4))
            wrong += res["bytes_wrong"]
            framing += res["framing_errors"]
            if res["first_error"]:
                print(f"reference: input {k}: {res['first_error']}",
                      file=sys.stderr, flush=True)
            ratio = max(ratio, len(member) / zl[k].get())
    finally:
        pool.close()
        pool.join()
    return {"calls_failed": (failed, 0),
            "bytes_wrong": (wrong, 0),
            "framing_errors": (framing, 0),
            "size_vs_zlib": (ratio, cfg["guarantees"]["size_vs_zlib"])}


def _zlib_len(data: bytes, level: int) -> int:
    return len(zlib.compress(data, level))
