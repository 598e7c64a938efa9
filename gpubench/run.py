"""Runs one cell of BENCHMARK.json on this machine's card and prints its
result as the last line of standard output.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  --trace 0 reports the cell's end-to-end
metrics, --trace 1 its per-layer metrics from a torch.profiler trace.
--control runs the cell's control instead (the program with one of the
configuration's guarantees given up): its `correct` has to come out
false.  Without a CUDA card, with fewer cards than the cell asks for, or
with the JAX package loaded once the window has closed, it prints no
result and exits with another code than 0.

Only the standard library is imported at the top: the reference's worker
processes start by importing this file."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "flate_tpu"}


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (flate_tpu_torch is not flate_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from gpubench import harness, registry

    bench = registry.benchmark()
    chips = registry.cell(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START,
                              control=args.control)
    bad = loaded_forbidden()
    if bad:
        print(f"no result: {bad} loaded in the process that measured",
              file=sys.stderr)
        return 3
    result["device"]["power"] = power_limit()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
