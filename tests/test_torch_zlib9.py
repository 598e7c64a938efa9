"""The deployment pigz -9 -z on the port, at a small size on the CPU: level-9
zlib members proven by the benchmark's plain reference
(gpubench/reference/member.py: a serial inflate of the body, the header and
the Adler-32 in the trailer), no longer than zlib.compress(input, 9); the
match stage's pass spans (encode.match.main, encode.match.k3 at levels 7-9
only, encode.match.extend) inside encode.match, the 3-byte pass once a
batch; and the spans, recording, change no byte of members the port's
tests pin.  The members are cut to 16 KiB shards but keep the
deployment's 32 KiB of context, zlib's own window: with less, a text
member comes out ~3 % longer than zlib's.  About 11-15 s a level-9 call
on one CPU thread."""

import hashlib
import zlib

import pytest
import torch

import flate_tpu_torch as ftt
from flate_tpu_torch import metrics
from flate_tpu_torch.containers import Container
from flate_tpu_torch.device import pipeline2
from gpubench.corpora import mixed, text
from gpubench.reference.member import check_member

from _torch_corpora import CTX, PINNED, S, corpus, sweep_input
from test_torch_pipeline2 import SQUEEZE_PINS

SMALL = dict(shard_len=16384, ctx=32768, batch=2, device="cpu")
N = 3 * 16384 + 5000             # three shards and a tail: two batches
SEED = 3_000_000_011
# the mixed corpus from here on holds text, one of its random blocks, text
MIXED_AT = 40_000
PASSES = ("encode.match.main", "encode.match.k3", "encode.match.extend")


def inputs(kind: str) -> bytes:
    if kind == "mixed":
        return mixed.make(MIXED_AT + N, SEED)[MIXED_AT:]
    return text.make(N, SEED)


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.disable()
    metrics.reset()
    yield
    metrics.disable()
    metrics.reset()
    torch.set_num_threads(n)


def encode_recorded(data: bytes, level: int) -> tuple[bytes, list]:
    """The zlib member of `data` with the spans recording, and its spans."""
    metrics.enable()
    out = ftt.zlib.compress(data, level=level, **SMALL)
    metrics.disable()
    return out, metrics.spans()


@pytest.mark.parametrize("kind", ["mixed", "text"])
def test_level9_member_proven_by_the_reference(kind):
    data = inputs(kind)
    out, sp = encode_recorded(data, 9)
    res = check_member(out, data, "zlib", False)
    assert res == {"bytes_wrong": 0, "framing_errors": 0,
                   "first_error": None}
    assert out[:2] == b"\x78\x9c"        # FLEVEL: the default at every level
    assert len(out) <= len(zlib.compress(data, 9))
    # the reference checks the trailer: a flipped Adler-32 bit is framing
    bad = out[:-1] + bytes([out[-1] ^ 1])
    assert check_member(bad, data, "zlib", False)["framing_errors"] == 1

    # the pass spans: children of encode.match, the 3-byte pass once a batch
    ids = {s["id"]: s for s in sp}
    names = [s["name"] for s in sp]
    batches = names.count("encode.dispatch")
    assert batches == 2
    for name in PASSES:
        assert names.count(name) == batches, name
    for s in sp:
        if s["name"] in PASSES:
            up = ids[s["parent"]]
            assert up["name"] == "encode.match"
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"]
    match = [s for s in sp if s["name"] == "encode.match"]
    for m in match:
        inner = [s["name"] for s in sp if s["parent"] == m["id"]]
        assert inner == list(PASSES)


@pytest.mark.parametrize("level", [6, 9])
def test_spans_change_no_byte(level):
    """Members pinned elsewhere, encoded with the spans recording, and the
    pass spans each opens: the level-6 zlib member of tests/_torch_corpora.py PINNED and the level-9
    member of tests/test_torch_pipeline2.py SQUEEZE_PINS."""
    metrics.enable()
    if level == 6:
        case = (6, 2048, 1024, 2, "ZLIB", "fuzz_mixed")
        data = sweep_input(case[5], 6, 2048, 2)
        out = pipeline2.compress_device2(data, 6, Container.ZLIB, 2048,
                                         1024, 2, device="cpu")
        pin = PINNED[case]
    else:
        data = corpus("text", 3 * S + 333, seed=9)
        out = pipeline2.compress_device2(data, level=9, shard_len=S, ctx=CTX,
                                         batch=2, device="cpu")
        pin = SQUEEZE_PINS[9, "text"]
    metrics.disable()
    assert hashlib.sha256(out).hexdigest() == pin
    # every batch opens the main pass and the extension; the 3-byte pass
    # only at level 9
    names = [s["name"] for s in metrics.spans()]
    batches = names.count("encode.dispatch")
    assert batches >= 2
    assert names.count("encode.match.main") == batches
    assert names.count("encode.match.extend") == batches
    assert names.count("encode.match.k3") == (batches if level == 9 else 0)
