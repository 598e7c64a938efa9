"""Near ties of build_fields' stored/coded decision: literal-only shards
whose segments' coded estimate lies within a hundredth of a bit of the
threshold stored_est + _HYST, and a search that holds the port's
build_fields to the jitted JAX one on them (ROADMAP C.18).

    JAX_PLATFORMS=cpu python tests/_torch_estimate_ties.py \
        [--seed 3] [--shards 4096]

prints the segments within 0.01 bits and every shard whose fields differ
from the JAX package's, alone (batch 1) and in a batch of up to 64 of them.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

S, SEG = 32_768, 1_024             # 32 segments a shard (encode2.seg_size)
THRESHOLD = 8 * SEG + 40 + 192     # stored_est + _HYST of a full segment


def _ebits(counts: np.ndarray) -> np.ndarray:
    """-log2(p) + 0.35 of a histogram, float64, unclipped: close enough to
    encode2._entropy_bits to aim a composition at the threshold."""
    p = (counts / counts.sum()).astype(np.float32)
    lg = np.log2(np.maximum(p, 1e-9).astype(np.float64)).astype(np.float32)
    return np.where(counts > 0, -lg + np.float32(0.35), 0).astype(np.float64)


def tie_shard(seed: int, index: int) -> np.ndarray:
    """(S,) uint8: 32 segments, each a shuffle of one byte composition
    with 0-4 random bytes replaced.  The composition is drawn from skewed
    weights whose entropy puts a segment's estimate near THRESHOLD, then
    moved a count at a time until the whole-shard estimate of one segment
    is within a bit of it."""
    rng = np.random.default_rng([seed, index])
    g = rng.exponential(1.0, 256) ** 2
    lo, hi = 0.0, 4.0
    for _ in range(30):                          # entropy 7.877 bits
        a = (lo + hi) / 2
        p = (1 + a * g) / (1 + a * g).sum()
        lo, hi = (a, hi) if -(p * np.log2(p)).sum() > 7.877 else (lo, a)
    comp = rng.multinomial(SEG, p)

    def margin(c):
        return float((c * _ebits(c)).sum()) - THRESHOLD

    m = margin(comp)
    for _ in range(20_000):
        if abs(m) < 1.0:
            break
        x, y = rng.integers(0, 256, 2)
        if comp[x] == 0 or x == y:
            continue
        comp[x] -= 1
        comp[y] += 1
        m1 = margin(comp)
        if abs(m1) < abs(m):
            m = m1
        else:
            comp[x] += 1
            comp[y] -= 1
    base = np.repeat(np.arange(256, dtype=np.uint8), comp)
    out = np.empty(S, np.uint8)
    for j in range(S // SEG):
        seg = base.copy()
        k = rng.integers(0, 5)
        seg[rng.integers(0, SEG, k)] = rng.integers(0, 256, k)
        out[j * SEG:(j + 1) * SEG] = rng.permutation(seg)
    return out


def literal_args(rows: np.ndarray) -> tuple:
    """build_fields' arguments for literal-only shards (numpy): window
    tail, mlen, mdist, starts, take, valid_len, final."""
    B = rows.shape[0]
    z = np.zeros((B, S), np.int32)
    return (rows, z, z, np.ones((B, S), bool), np.zeros((B, S), bool),
            np.full(B, S, np.int32), np.zeros(B, np.int32))


def margins(rows: np.ndarray) -> np.ndarray:
    """(B, 32) the port's estimate of each segment (encode2._coded_est's
    exact float64 sum, before its rounding) less the threshold."""
    import torch
    from flate_tpu_torch.device import encode2
    B = rows.shape[0]
    seg = np.arange(B)[:, None] * (S // SEG) + np.arange(S)[None, :] // SEG
    h = torch.from_numpy(np.bincount((seg * 286 + rows).ravel(),
                                     minlength=B * 32 * 286)
                         ).reshape(B, 32, 286)
    eb = encode2._entropy_bits(h.sum(dim=1)).to(torch.float64)
    return ((h * eb[:, None, :]).sum(dim=2) - THRESHOLD).numpy()


def fields(rows: np.ndarray, jax_side: bool):
    """(bits, total_bits) of build_fields on literal-only shards."""
    args = literal_args(rows)
    if jax_side:
        import jax.numpy as jnp
        from flate_tpu.jx import encode2 as j_encode2
        out = j_encode2.build_fields(*(jnp.asarray(a) for a in args), S, SEG)
        return np.asarray(out[1]), np.asarray(out[2])
    import torch
    from flate_tpu_torch.device import encode2
    out = encode2.build_fields(*(torch.from_numpy(a) for a in args), S, SEG)
    return out[1].numpy(), out[2].numpy()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--shards", type=int, default=4096)
    a = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    near_total, picked = 0, []
    for i in range(a.shards):
        row = tie_shard(a.seed, i)[None, :]
        near = np.abs(margins(row)[0]) < 0.01
        if near.any():
            near_total += int(near.sum())
            picked.append(i)
    print(f"{a.shards} shards, {32 * a.shards} segments: {near_total} "
          f"within 0.01 bits of the threshold, in {len(picked)} shards")
    for c in range(0, len(picked), 64):
        idx = picked[c:c + 64]
        rows = np.stack([tie_shard(a.seed, i) for i in idx])
        port = fields(rows, False)
        batch = fields(rows, True)
        for r, i in enumerate(idx):
            alone = fields(rows[r:r + 1], True)
            diff = [name for name, j, k in (("batch 1", alone, 0),
                                            (f"batch {len(idx)}", batch, r))
                    if not (np.array_equal(j[0][k], port[0][r])
                            and j[1][k] == port[1][r])]
            if diff:
                print(f"shard ({a.seed}, {i}): total bits port "
                      f"{port[1][r]}, JAX batch 1 {alone[1][0]}, batch "
                      f"{len(idx)} {batch[1][r]}; differs at "
                      f"{', '.join(diff)}", flush=True)


if __name__ == "__main__":
    main()
