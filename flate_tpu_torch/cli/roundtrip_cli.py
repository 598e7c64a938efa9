"""Round-trip check on the device codec:

    python -m flate_tpu_torch.cli.roundtrip_cli [--device cuda|cpu] < FILE

Compresses stdin as a raw deflate stream at levels 1-9, then in the
huffman and store modes, decompresses each and compares it with the input.
Exit 0 when every mode gives the input back, else 1.
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flate-torch-roundtrip")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import flate_tpu_torch as ftt
    data = sys.stdin.buffer.read()
    for level in range(1, 10):
        blob = ftt.flate.compress(data, level, device=args.device)
        if ftt.flate.decompress(blob, device=args.device) != data:
            print(f"FAIL level {level}", file=sys.stderr)
            return 1
    for name in ("huffman", "store"):
        sub = getattr(ftt.flate, name)
        if sub.decompress(sub.compress(data), device=args.device) != data:
            print(f"FAIL {name}", file=sys.stderr)
            return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
