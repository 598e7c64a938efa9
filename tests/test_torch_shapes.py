"""The port's one-shot encode at the shard shapes its card sweep pins
(tests/_torch_corpora.py PINNED: the own members of chip_smoke.py phase 17
at 2048 / 1024 / 2, ctx above the shard, a shard_len that is no power of
two) against flate_tpu.jx.pipeline2.compress_device2(interpret=True),
byte for byte, and both against the sha256 that the card test
(tests/test_torch_cuda.py test_cuda_bytes_equal_cpu) holds the card's
bytes to.  Also: the sweep's sample, the stage helper that names the
first differing stage on the card, and phase 17's count of mutations
CPython accepts."""

import zlib

import pytest
import torch

from flate_tpu.containers import Container as JContainer
from flate_tpu.jx import pipeline2 as j_pipeline2

from flate_tpu_torch.containers import Container, parse_header
from flate_tpu_torch.device import pipeline2

from _torch_corpora import (CONTAINERS, OWN_SHAPES, PINNED, SWEEP_BATCH,
                            SWEEP_CTX, SWEEP_INPUTS, SWEEP_LEVELS,
                            SWEEP_SHARDS, WBITS, encode_stages, sha256,
                            sweep_cases, sweep_id, sweep_input)

torch.set_num_threads(1)         # the squeeze DP is thousands of tiny ops


@pytest.mark.parametrize("case", list(PINNED), ids=sweep_id)
def test_pinned_bytes_equal_jax(case):
    level, shard_len, ctx, batch, container, name = case
    data = sweep_input(name, level, shard_len, batch)
    kw = dict(level=level, shard_len=shard_len, ctx=ctx, batch=batch)
    ref = j_pipeline2.compress_device2(
        data, container=JContainer[container], interpret=True, **kw)
    out = pipeline2.compress_device2(data, container=Container[container],
                                     device="cpu", **kw)
    assert out == ref, (len(out), len(ref))
    assert sha256(ref) == PINNED[case]
    assert zlib.decompress(out, WBITS[container]) == data


def test_sweep_sample_covers_the_grid():
    """At least 60 drawn cases with the own-member shapes first, every
    value of every axis drawn, and ctx above the shard and a shard_len
    that is no power of two among them; the sample is the same on every
    call (the card test parametrises over it)."""
    cases = sweep_cases()
    assert cases == sweep_cases()
    drawn = cases[:60]
    assert tuple(drawn[:3]) == OWN_SHAPES
    assert len(set(drawn)) == 60
    for i, axis in enumerate((SWEEP_LEVELS, SWEEP_SHARDS, SWEEP_CTX,
                              SWEEP_BATCH, CONTAINERS, SWEEP_INPUTS)):
        assert {c[i] for c in drawn} == set(axis)
    assert any(c[2] > c[1] for c in drawn)
    assert any(c[1] & (c[1] - 1) for c in drawn)
    assert set(PINNED) <= set(cases)


@pytest.mark.parametrize("case", [OWN_SHAPES[0], OWN_SHAPES[1],
                                  (7, 1024, 4096, 3, "GZIP", "text"),
                                  (3, 7168, 512, 1, "ZLIB", "zeros")],
                         ids=sweep_id)
def test_encode_stages_compose_to_the_member(case):
    """encode_stages runs compress_device2's batches through the stages
    in order: its compacted bytes are the member's body, so a stage it
    names on the card is a stage of the real path."""
    level, shard_len, ctx, batch, container, name = case
    data = sweep_input(name, level, shard_len, batch)
    member = pipeline2.compress_device2(
        data, level, Container[container], shard_len, ctx, batch,
        device="cpu")
    stages = encode_stages(data, level, shard_len, ctx, batch, "cpu",
                           container)
    names = [n for j, n, _ in stages if j == 0]
    assert names[0] == "prime_windows" and names[-1] == "compact_meta"
    assert ("greedy_ll_bits" in names) == (level not in (1, 3))
    assert ("k3_matcher" in names) == (level >= 7)
    body = b"".join(bytes(t.numpy()) for _, n, t in stages
                    if n == "compact_bytes")
    head, _ = parse_header(Container[container], member)
    tail = {"RAW": 0, "ZLIB": 4, "GZIP": 8}[container]
    assert member[head:len(member) - tail] == body


def test_phase17_accepted_mutations():
    """chip_smoke.py phase 17's mutation sets depend on the own members
    alone: with the CPU's members, CPython accepts 99 raw, 1 zlib and 2
    gzip mutations (102, the count phase 17 shows on the card); without
    OWN_GZIP_167 among the gzip seeds it accepts none of the gzip ones
    (100 in all)."""
    import chip_smoke as cs
    n = {"RAW": 300, "ZLIB": 100, "GZIP": 100}

    def accepted(c, seeds):
        return sum(cs.python_accepts(c, m) is not None
                   for m in cs.mutants(seeds, n[c]))

    seeds = {c: cs.fuzz_seeds(c, cs.own_member(c, "cpu")) for c in n}
    assert [accepted(c, seeds[c]) for c in n] == [99, 1, 2]
    assert accepted("GZIP", [s for s in seeds["GZIP"]
                             if s != cs.OWN_GZIP_167]) == 0
