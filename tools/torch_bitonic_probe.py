"""The bitonic sort probe (tools/bitonic_probe.py) on the port's kernel B10.

Runs the probe's network (flate_tpu_torch/device/bitonic.py) on rows of
2^18 u32 elements: a key and BP_NOPS-1 carried operands (default 9, read as
the JAX tool reads it).

    python3 tools/torch_bitonic_probe.py

Without a CUDA card: correctness() through the plain PyTorch version (the
full 171-substage network on one row equals np.sort, and operand 1 follows
its key).  On the card: the same check through the kernel, then
calibrate(): the tool's eight-substage mix at B = 8, ms per substage per
row, the full sort (171 substages x 64 rows) extrapolated from it beside
the measured full sort and torch.sort + torch.gather on the same rows.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flate_tpu_torch.device import bitonic  # noqa: E402

R, C = bitonic.R, bitonic.C
N = R * C
NOPS = int(os.environ.get("BP_NOPS", "9"))  # key + carried operands


def correctness(device: torch.device) -> None:
    """Full 2^18 bitonic on one row equals np.sort; operand 1 follows its
    key."""
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, (1, R, C), dtype=np.uint32)
    ops = [key + np.uint32(i + 1) for i in range(NOPS - 1)]
    out = bitonic.run(torch.from_numpy(key).to(device),
                      [torch.from_numpy(o).to(device) for o in ops],
                      bitonic.bitonic_stages(N))
    got = out[0].cpu().numpy().reshape(-1)
    assert (got == np.sort(key.reshape(-1))).all(), "bitonic key order wrong"
    if NOPS > 1:
        assert (out[1].cpu().numpy().reshape(-1) == got + np.uint32(1)).all()
    print(f"correctness ({device.type}): OK", flush=True)


def _ms(fn, reps: int) -> float:
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


def _rows(rng, B: int, device: torch.device):
    key = rng.integers(0, 2**32, (B, R, C), dtype=np.uint32)
    ops = [torch.from_numpy(key + np.uint32(i)).to(device)
           for i in range(NOPS - 1)]
    return torch.from_numpy(key).to(device), ops


def library_sort(key: torch.Tensor, ops) -> tuple:
    """torch.sort of the keys (as int64: CUDA sorts no uint32) and one
    torch.gather per operand: the library call that computes the sorted
    payload of unique keys."""
    B = key.shape[0]
    k64 = key.reshape(B, -1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    s, idx = torch.sort(k64, dim=1)
    return (s, *[torch.gather(o.reshape(B, -1), 1, idx) for o in ops])


def calibrate(device: torch.device, B: int = 8) -> None:
    """Time the mix on the card; extrapolate; time the full sort."""
    rng = np.random.default_rng(0)
    key, ops = _rows(rng, B, device)
    mix = bitonic.CALIBRATE_MIX
    ms = _ms(lambda: bitonic.run(key, ops, mix), 5)
    per_sub = ms / len(mix) / B              # ms per substage per row
    full_est = per_sub * 171 * 64            # 171 substages, 64 rows
    key, ops = _rows(rng, 64, device)
    stages = bitonic.bitonic_stages(N)
    full = _ms(lambda: bitonic.run(key, ops, stages), 3)
    lib = _ms(lambda: library_sort(key, ops), 3)
    print(f"{len(mix)} substages x {B} rows: {ms:.4f} ms -> "
          f"{per_sub * 1e3:.3f} us/substage/row -> full sort est "
          f"{full_est:.4f} ms; measured full sort (171 substages x 64 rows, "
          f"{NOPS} arrays) {full:.4f} ms; torch.sort + gather {lib:.4f} ms",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        correctness(torch.device("cpu"))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    correctness(dev)
    calibrate(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
