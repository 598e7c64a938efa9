"""The field build's kernels (csrc/field_kernels.cu F1-F3, encode2's
_build_fields_kernels) against its plain version (_build_fields_plain),
element for element: vals, bits, total_bits and kind.

The card cases (`-m cuda`, skipped without a card) run the port's own
stages on the card for the parses: full width at levels 1, 6 and 9 (64 x
128 KiB shards after 32 KiB of context, segments of 4,096), small shards
(4,096 positions in segments of 1,024), random bytes (all-stored shards),
literal-only shards (no distance code), runs at one distance (one distance
symbol), valid lengths of 0 and 1 (an end-of-block alone), final flags, a
foreign parse whose tokens cross segments with S not a multiple of the
segment, and the near ties of tests/_torch_estimate_ties.py; and the
fields captured in a CUDA graph against the eager launches.  On the CPU
the wrapper runs the plain version and launches nothing.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fields_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flate_tpu_torch import _build
from flate_tpu_torch.device import encode2, match2, pipeline2

from _torch_corpora import corpus
from _torch_estimate_ties import SEG as TIE_SEG, literal_args, tie_shard

FIELD_KERNELS = tuple(_build.FIELD_KERNELS)


def _t(x, device):
    return torch.from_numpy(np.array(x)).to(device)


def staged_args(data: bytes, level: int, B: int, S: int, ctx: int,
                device, valid=None, finals=None):
    """build_fields' arguments from the port's stages at a level's knobs,
    as encode_core runs them on `device`: B shards of S bytes of `data`
    after ctx bytes of context; valid (B,) defaults to S with the last
    row 12,345 short (or half), finals to the last row set."""
    arr = np.frombuffer(data[:ctx + B * S], np.uint8)
    shards = _t(arr[ctx:].reshape(B, S), device)
    ctx0 = _t(arr[:ctx], device)
    window = pipeline2._prime_windows(shards, ctx0, ctx)
    lvl = pipeline2.level_params(level, S)
    blk = lvl["blk"]
    if valid is None:
        valid = np.full(B, S, np.int32)
        valid[-1] = S - min(12345, S // 2)
    if finals is None:
        finals = np.zeros(B, np.int32)
        finals[-1] = 1
    valid, finals = _t(np.asarray(valid, np.int32), device), \
        _t(np.asarray(finals, np.int32), device)
    ctx_len = torch.full((B,), ctx, dtype=torch.int32, device=device)
    ml, md = match2.find_matches_fused(window, ctx_len, valid, K=lvl["K"],
                                       nw=lvl["nw"], ctx=ctx, K3=lvl["K3"])
    take, starts, ml, md = pipeline2._parse_stage(
        ml, md, lazy=lvl["lazy"], max_lazy=lvl["max_lazy"], ctx=ctx, blk=blk)
    wt, m_r, d_r = window[:, ctx:], ml[:, ctx:], md[:, ctx:]
    take_r, starts_r = take[:, ctx:], starts[:, ctx:]
    if lvl["squeeze"]:
        take_r, starts_r, m_r = pipeline2._squeeze_stage(
            wt, m_r, d_r, take_r, starts_r, valid, blk=blk)
    return (wt, m_r, d_r, starts_r, take_r, valid, finals, S,
            encode2.seg_size(S, blk))


def foreign_args(B: int, S: int, seg: int, seed: int, device,
                 match_p: float = 0.3, lengths=(3, 259)):
    """A foreign, non-block-aligned parse: tokens of seeded lengths (3-258)
    and distances 1-32,768 wherever they fall, a match at a share match_p
    of the tokens, so that many cross a segment's end (and the shard's: S
    need not be a multiple of seg); junk lengths and distances where no
    match starts.  Every row final."""
    rng = np.random.default_rng(seed)
    wt = rng.integers(0, 256, (B, S)).astype(np.uint8)
    wt[:, ::3] = 97                     # some skew for the tables
    wt[:, 1::3] &= 15
    ml = rng.integers(0, 300, (B, S)).astype(np.int32)
    md = rng.integers(0, 40000, (B, S)).astype(np.int32)
    starts = np.zeros((B, S), bool)
    take = rng.random((B, S)) < 0.5
    for b in range(B):
        p = 0
        while p < S:
            starts[b, p] = True
            if rng.random() < match_p:
                ml[b, p] = int(rng.integers(*lengths))
                md[b, p] = int(rng.integers(1, 32769))
                take[b, p] = True
                p += int(ml[b, p])
            else:
                take[b, p] = False
                p += 1
    valid = np.full(B, S, np.int32)
    valid[0] = S - 777
    return (_t(wt, device), _t(ml, device), _t(md, device),
            _t(starts, device), _t(take, device), _t(valid, device),
            _t(np.ones(B, np.int32), device), S, seg)


def _runs_one_distance(n: int) -> bytes:
    """Bytes whose every match is at distance 3."""
    return (b"abc" * (n // 3 + 1))[:n]


def _literal(data: bytes, B: int, S: int, device, valid=None):
    """Literal-only shards (a token at every position, no match)."""
    rows = np.frombuffer(data[:B * S], np.uint8).reshape(B, S)
    z = np.zeros((B, S), np.int32)
    v = np.full(B, S, np.int32) if valid is None else np.asarray(valid,
                                                                 np.int32)
    return (_t(rows, device), _t(z, device), _t(z, device),
            _t(np.ones((B, S), bool), device),
            _t(np.zeros((B, S), bool), device), _t(v, device),
            _t(np.zeros(B, np.int32), device), S, encode2.seg_size(S))


def _ties(device):
    """Near ties of the stored/coded estimate (tie_shard(3, 649) and
    (3, 2970)) beside a zero row."""
    rows = np.stack([tie_shard(3, 649), tie_shard(3, 2970),
                     np.zeros_like(tie_shard(3, 649))])
    args = literal_args(rows)
    return tuple(_t(a, device) for a in args) + (rows.shape[1], TIE_SEG)


FULL = dict(B=64, S=131072, ctx=32768)
SMALL = dict(B=4, S=4096, ctx=512)


def field_args(case: str, device):
    """build_fields' arguments of one named case on `device`."""
    if case.startswith("full-l"):
        from chip_smoke import mixed_corpus
        n = FULL["ctx"] + FULL["B"] * FULL["S"]
        return staged_args(mixed_corpus(n), int(case[6:]), device=device,
                           **FULL)
    if case.startswith("small-l"):
        return staged_args(corpus("mixed", 20000 + 4 * 4096, seed=5),
                           int(case[7:]), device=device, **SMALL)
    if case == "random":
        return staged_args(corpus("random", 20000, seed=6), 6,
                           device=device, **SMALL)
    if case == "runs-one-distance":
        return staged_args(_runs_one_distance(20000), 1, device=device,
                           **SMALL)
    if case == "valid-0-1":
        return staged_args(corpus("text", 20000, seed=7), 6, device=device,
                           valid=[0, 1, 4095, 4096], finals=[1, 0, 1, 0],
                           **SMALL)
    if case == "literal":
        return _literal(corpus("text", 4 * 4096, seed=8), 4, 4096, device)
    if case == "literal-valid-0":
        return _literal(corpus("text", 4 * 4096, seed=9), 4, 4096, device,
                        valid=[0, 0, 1, 2])
    if case == "foreign":
        return foreign_args(3, 5000, 1024, 10, device)
    if case == "foreign-one-segment":
        return foreign_args(2, 3000, 4096, 11, device)
    if case == "few-short-matches":     # literal-only tables win
        return foreign_args(3, 8192, 1024, 12, device, match_p=0.002,
                            lengths=(3, 4))
    if case == "ties":
        return _ties(device)
    raise ValueError(case)


CASES = ["full-l1", "full-l6", "full-l9", "small-l1", "small-l6",
         "small-l9", "random", "runs-one-distance", "valid-0-1", "literal",
         "literal-valid-0", "foreign", "foreign-one-segment",
         "few-short-matches", "ties"]


def equal_fields(got, want) -> None:
    """(vals, bits, total_bits, kind) element for element."""
    for name, a, b in zip(("vals", "bits", "total_bits", "kind"), got, want):
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        a, b = a.cpu(), b.cpu()
        if not torch.equal(a, b):
            bad = (a != b).nonzero()
            raise AssertionError(f"{name}: {bad.shape[0]} elements differ, "
                                 f"first at {bad[0].tolist()}: "
                                 f"{a[tuple(bad[0])]} != {b[tuple(bad[0])]}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["graph"])
def test_fields_kernels_equal_plain(cuda, case):
    """F1-F3, three launches, equal to the plain version on the same card
    tensors; "graph": the full-width level-6 fields captured in a CUDA
    graph and replayed equal the eager launches."""
    args = field_args("full-l6" if case == "graph" else case, cuda)
    want = encode2._build_fields_plain(*args)
    _build.LAUNCHES.clear()
    got = encode2.build_fields(*args)
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] for k in FIELD_KERNELS} == \
        dict.fromkeys(FIELD_KERNELS, 1)
    equal_fields(got, want)
    if case != "graph":
        return
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        encode2.build_fields(*args)             # warm-up off the main stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = encode2.build_fields(*args)
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    equal_fields(out, want)


def test_fields_cpu_runs_the_plain_version(monkeypatch):
    """On CPU tensors build_fields is the plain version and launches
    nothing."""
    def no_launch(name, *args):
        raise AssertionError(f"{name} launched on the CPU")
    monkeypatch.setattr(_build, "launch", no_launch)
    for case in ("small-l6", "foreign"):
        args = field_args(case, "cpu")
        equal_fields(encode2.build_fields(*args),
                     encode2._build_fields_plain(*args))



@pytest.mark.cuda
def test_fields_wrapper_rejects_bad_tensors(cuda):
    """The kernels' wrapper takes uint8 / int32 / bool rows and int32 or
    int64 vectors, each row contiguous, and raises on anything else."""
    args = list(field_args("small-l1", cuda))
    for i, bad, err in ((1, args[1].to(torch.int64), TypeError),
                        (2, args[2].repeat(1, 2)[:, ::2], ValueError),
                        (3, args[3].to(torch.uint8), TypeError),
                        (5, args[5].to(torch.float32), TypeError),
                        (6, args[6][:2], ValueError)):
        with pytest.raises(err):
            encode2.build_fields(*args[:i], bad, *args[i + 1:])
