"""The port's one-shot encode at the headline's shard shape (128 KiB shards,
32 KiB context) against the JAX package's bytes at every level: the port's
CPU bytes against the sha256 of flate_tpu.jx.pipeline2.compress_device2(
interpret=True) pinned in chip_smoke.py PROD_PINNED (chip_smoke.py phase 8
holds the card's bytes, staged, fused and through the public entry point,
to the same pins).  The inputs are bench.py's corpora (chip_smoke.py
prod_input): one full shard and a tail, two full shards in one batch, the
headline's first 8 MiB batch (at level 6 in gzip, at level 9 in zlib)
and its whole 32 MiB at level 6.

The JAX encode takes 10-70 s a case at levels 1-6 and 3 to 17 minutes at
levels 7-9 in interpret mode (its 8 MiB batch 7 minutes, the 32 MiB 4
batches of about 6.6 minutes), so the slow tests recompute every pin.  The
port's side takes under 11 s a case on one CPU thread, ~20 s at level 9
(those cases: tests/test_torch_prodshape_l9.py), and 2-6 minutes on the
8 MiB batch (slow, and four times that on the 32 MiB).  Tolerance: none, the bytes are
equal or the case fails."""

import hashlib
import zlib

import pytest
import torch

from flate_tpu.containers import Container as JContainer
from flate_tpu.jx import pipeline2 as j_pipeline2

from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import pipeline2

from _torch_corpora import WBITS
from chip_smoke import PROD_PINNED, prod_id, prod_input

torch.set_num_threads(1)         # the squeeze DP is thousands of tiny ops


def _port(case, data):
    level, shard_len, ctx, batch, container, _ = case
    return pipeline2.compress_device2(
        data, level, Container[container], shard_len, ctx, batch,
        device="cpu")


def check_port(case):
    """The port's CPU bytes of a case: the pin's sha256, and zlib decodes
    them to the input."""
    data = prod_input(case[5])
    out = _port(case, data)
    assert hashlib.sha256(out).hexdigest() == PROD_PINNED[case], len(out)
    assert zlib.decompress(out, WBITS[case[4]]) == data


def test_pins_cover_the_matrix():
    """Mixed at every level in gzip, zlib and raw at levels 1, 6 and 9,
    text at 6 and 9, two full shards in one batch, the headline's first
    batch (at level 6 in gzip and at level 9 in zlib) and its whole 32 MiB,
    all at 128 KiB shards with 32 KiB of context."""
    S, CTX = 131_072, 32_768
    assert {c[1:3] for c in PROD_PINNED} == {(S, CTX)}
    got = {(c[0], c[3], c[4], c[5]) for c in PROD_PINNED}
    want = ({(L, 1, "GZIP", "mixed") for L in range(1, 10)}
            | {(L, 1, c, "mixed") for L in (1, 6, 9) for c in ("ZLIB", "RAW")}
            | {(6, 1, "GZIP", "text"), (9, 1, "GZIP", "text"),
               (6, 2, "GZIP", "mixed2"), (6, 64, "GZIP", "mixed8M"),
               (9, 64, "ZLIB", "mixed8M"), (6, 64, "GZIP", "mixed32M")})
    assert got == want
    assert all(len(h) == 64 for h in PROD_PINNED.values())
    assert len(prod_input("mixed")) == S + 12_345
    assert prod_input("mixed8M")[:S + 12_345] == prod_input("mixed")
    big = prod_input("mixed32M")
    assert len(big) == 32 << 20 and big[:8 << 20] == prod_input("mixed8M")


@pytest.mark.parametrize("case", [c for c in PROD_PINNED
                                  if c[0] < 9 and c[3] < 64], ids=prod_id)
def test_port_bytes_equal_pin(case):
    check_port(case)


@pytest.mark.slow
@pytest.mark.parametrize("case", [c for c in PROD_PINNED if c[3] == 64],
                         ids=prod_id)
def test_headline_batch_equal_pin(case):
    check_port(case)


@pytest.mark.slow
@pytest.mark.parametrize("case", list(PROD_PINNED), ids=prod_id)
def test_jax_bytes_equal_pin(case):
    """The pins recomputed: the JAX package in interpret mode."""
    level, shard_len, ctx, batch, container, name = case
    data = prod_input(name)
    ref = j_pipeline2.compress_device2(
        data, level=level, container=JContainer[container],
        shard_len=shard_len, ctx=ctx, batch=batch, interpret=True)
    assert hashlib.sha256(ref).hexdigest() == PROD_PINNED[case]
    assert _port(case, data) == ref
