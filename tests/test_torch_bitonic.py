"""The port's bitonic network (flate_tpu_torch/device/bitonic.py, the
counterpart of kernel B10) against tools/bitonic_probe.run in Pallas
interpret mode: keys and every carried operand equal element for element,
duplicated operands of equal keys included.  Exact."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flate_tpu_torch.device import bitonic

TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "bitonic_probe.py"
N = bitonic.R * bitonic.C
MIX = bitonic.CALIBRATE_MIX


@pytest.fixture(scope="module")
def probe():
    """tools/bitonic_probe.py loaded as a module, BP_NOPS unset (NOPS=9)."""
    spec = importlib.util.spec_from_file_location("bitonic_probe", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.NOPS == 9
    return mod


def _both(probe, key, ops, stages):
    ref = probe.run(jnp.asarray(key), [jnp.asarray(o) for o in ops],
                    tuple(stages), interpret=True)
    out = bitonic.run(torch.from_numpy(key),
                      [torch.from_numpy(o) for o in ops], stages)
    ref = [np.asarray(r) for r in ref]
    got = [o.numpy() for o in out]
    assert len(got) == len(ref) == 1 + len(ops)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == np.uint32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r, err_msg=f"array {i}")
    return got


def _keys(rng, B, high=2**32):
    return rng.integers(0, high, (B, bitonic.R, bitonic.C), dtype=np.uint32)


def test_full_network_one_row(probe):
    """All 171 substages on one row of unique random keys (hash<<18 | pos,
    as the matcher's) with 8 distinct random operands: the key comes out
    sorted and every operand followed it."""
    rng = np.random.default_rng(0)
    key = ((rng.integers(0, 1 << 14, N, dtype=np.uint32) << np.uint32(18))
           | rng.permutation(N).astype(np.uint32)).reshape(1, bitonic.R,
                                                            bitonic.C)
    ops = [_keys(rng, 1) for _ in range(8)]
    got = _both(probe, key, ops, bitonic.bitonic_stages(N))
    np.testing.assert_array_equal(got[0].reshape(-1),
                                  np.sort(key.reshape(-1)))
    order = np.argsort(key.reshape(-1))
    for g, o in zip(got[1:], ops):
        np.testing.assert_array_equal(g.reshape(-1), o.reshape(-1)[order])


def test_calibrate_mix_two_rows(probe):
    """The probe's eight-substage calibrate mix on B = 2, operands key + i
    as the probe makes them."""
    assert MIX == ((131072, 262144), (1024, 262144), (64, 262144),
                   (8, 262144), (1, 262144), (2048, 262144), (256, 262144),
                   (16, 262144))
    rng = np.random.default_rng(1)
    key = _keys(rng, 2)
    ops = [key + np.uint32(i) for i in range(8)]
    _both(probe, key, ops, MIX)


@pytest.mark.parametrize("stages", ["full", "one"])
def test_duplicate_keys(probe, stages):
    """Keys from 0-15 (every key repeated ~16,000 times) with distinct
    operands: equal keys duplicate operands, and the port duplicates the
    same ones."""
    rng = np.random.default_rng(2)
    key = _keys(rng, 1, high=16)
    ops = [rng.permutation(N).astype(np.uint32).reshape(key.shape) + i
           for i in range(8)]
    st = bitonic.bitonic_stages(N) if stages == "full" else ((1, 2),)
    got = _both(probe, key, ops, st)
    if stages == "full":
        np.testing.assert_array_equal(got[0].reshape(-1),
                                      np.sort(key.reshape(-1)))
        # operands are duplicated: fewer distinct values than elements
        assert len(np.unique(got[1])) < N


def test_equal_keys_copy_not_swap(probe):
    """Keys [5, 5, 7, 7], operands [0, 1, 2, 3], stage (1, 2): in the
    ascending pair element 1 copies element 0, in the descending pair
    element 2 copies element 3."""
    key = np.full((1, bitonic.R, bitonic.C), 9, dtype=np.uint32)
    key.reshape(-1)[:4] = [5, 5, 7, 7]
    op = np.arange(N, dtype=np.uint32).reshape(key.shape)
    got = _both(probe, key, [op] * 8, ((1, 2),))
    for g in got[1:]:
        assert g.reshape(-1)[:4].tolist() == [0, 0, 3, 3]


def test_stages_equal_tools_list(probe, monkeypatch):
    """bitonic_stages(2**18) is the list the probe's correctness() builds:
    capture it from the tool's own call of run."""
    seen = []

    def capture(key, ops, stages, interpret=False):
        seen.append(stages)
        k = np.sort(np.asarray(key).reshape(-1)).reshape(key.shape)
        return (k, k + np.uint32(1))

    monkeypatch.setattr(probe, "run", capture)
    probe.correctness()
    assert len(seen) == 1
    assert bitonic.bitonic_stages(N) == tuple(seen[0])
    assert len(seen[0]) == 171


def test_int32_bit_patterns_and_no_operands():
    """int32 bit patterns sort as u32 and come back as int32; a key with no
    operands and an empty stage list are accepted."""
    rng = np.random.default_rng(3)
    key = _keys(rng, 1)
    (k32,) = bitonic.run(torch.from_numpy(key.view(np.int32)), [],
                         bitonic.bitonic_stages(N))
    assert k32.dtype == torch.int32
    np.testing.assert_array_equal(k32.numpy().view(np.uint32).reshape(-1),
                                  np.sort(key.reshape(-1)))
    k, o = bitonic.run(torch.from_numpy(key), [torch.from_numpy(key)], ())
    assert torch.equal(k, o) and np.array_equal(k.numpy(), key)


@pytest.mark.parametrize("stages", [((3, 4),), ((0, 2),), ((N, 2 * N),)])
def test_bad_substage_raises(stages):
    key = torch.zeros((1, bitonic.R, bitonic.C), dtype=torch.uint32)
    with pytest.raises(ValueError):
        bitonic.run(key, [], stages)


def test_bad_operand_raises():
    key = torch.zeros((1, bitonic.R, bitonic.C), dtype=torch.uint32)
    with pytest.raises(ValueError):
        bitonic.run(key, [torch.zeros((2, bitonic.R, bitonic.C),
                                      dtype=torch.uint32)], ((1, 2),))
    with pytest.raises(TypeError):
        bitonic.run(key.to(torch.int64), [], ((1, 2),))


# ---------------------------------------------------------------------------
# the kernel's pass plan (plan_passes)
# ---------------------------------------------------------------------------

T = bitonic.TILE
# j = tile/2, tile and 2*tile, and six consecutive substages with j >= tile
# (one j twice in a row)
AROUND_TILE = ((T // 2, N), (T, N), (2 * T, N), (T // 2, 4 * T), (1, 2),
               (8 * T, N), (4 * T, N), (2 * T, N), (T, N), (4 * T, 2 * N),
               (4 * T, 8 * T), (T, 2 * T), (T // 2, N))
PLANS = {"full": (bitonic.bitonic_stages(N), N),
         "mix": (MIX, N),
         "around_tile": (AROUND_TILE, N),
         "short_rows": (bitonic.bitonic_stages(1 << 12), 1 << 12),
         "long_tile_run": (tuple((1 << (i % 14), N) for i in range(300)), N)}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_covers_every_substage_in_order(name):
    stages, n = PLANS[name]
    plan = bitonic.plan_passes(stages, n)
    assert tuple(st for _, run in plan for st in run) == tuple(stages)
    for kind, run in plan:
        assert run
        if kind == "tile":
            assert all(j < T for j, _ in run) and len(run) <= bitonic.RUN_MAX
        else:
            assert kind == "device"
            assert all(j >= T for j, _ in run)
            assert len(run) <= bitonic.DEV_MAX
    for (k0, r0), (k1, _) in zip(plan, plan[1:]):
        # a group ends at a change of kind or at its cap
        assert k0 != k1 or len(r0) == (bitonic.RUN_MAX if k0 == "tile"
                                       else bitonic.DEV_MAX)


def test_plan_pass_counts():
    """The full 2^18 network: one tile pass for k <= 2^14, then a
    device-memory pass (1, 2, 3, 4 substages) and a tile pass (14) for each
    k from 2^15 to 2^18; the calibrate mix: one of each; rows shorter than
    a tile: one tile pass; no substages: no pass."""
    full = bitonic.plan_passes(*PLANS["full"])
    assert [(k, len(r)) for k, r in full] == \
        [("tile", 105)] + [g for m in (1, 2, 3, 4)
                           for g in (("device", m), ("tile", 14))]
    assert [(k, len(r)) for k, r in bitonic.plan_passes(MIX, N)] == \
        [("device", 1), ("tile", 7)]
    short = bitonic.plan_passes(*PLANS["short_rows"])
    assert [(k, len(r)) for k, r in short] == [("tile", 78)]
    assert bitonic.plan_passes((), N) == ()
    assert [len(r) for _, r in bitonic.plan_passes(*PLANS["long_tile_run"])
            ] == [128, 128, 44]


@pytest.mark.parametrize("name", ["mix", "around_tile"])
def test_plain_group_by_group_equals_whole_and_probe(probe, name):
    """_run_plain applied pass by pass, as the kernel runs the plan, equals
    _run_plain on the whole list and the probe in interpret mode."""
    stages, n = PLANS[name]
    rng = np.random.default_rng(7)
    key = _keys(rng, 1, high=1 << 12)           # many equal keys
    ops = [_keys(rng, 1) for _ in range(8)]
    whole = _both(probe, key, ops, stages)
    out = (torch.from_numpy(key), *[torch.from_numpy(o) for o in ops])
    for _, run in bitonic.plan_passes(stages, n):
        out = bitonic._run_plain(out[0], out[1:], run)
    for g, w in zip(out, whole):
        np.testing.assert_array_equal(g.numpy(), w)
