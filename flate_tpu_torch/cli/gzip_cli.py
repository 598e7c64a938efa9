"""gzip CLI on the device encoder:

    python -m flate_tpu_torch.cli.gzip_cli [-l LEVEL] [-o OUT] [-c]
        [--device cuda|cpu] FILE          -> FILE.gz (or OUT, or stdout)

Reads the whole file and compresses it with flate_tpu_torch.gzip.compress,
so the member carries the FLT1 shard index and decodes shard-parallel on
the device.
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flate-torch-gzip")
    ap.add_argument("file")
    ap.add_argument("-l", "--level", type=int, default=6)
    ap.add_argument("-o", "--output")
    ap.add_argument("-c", "--stdout", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import flate_tpu_torch as ftt
    with open(args.file, "rb") as f:
        data = f.read()
    if args.stdout:
        ftt.gzip.compress(data, args.level, writer=sys.stdout.buffer,
                          device=args.device)
        return 0
    with open(args.output or args.file + ".gz", "wb") as out:
        ftt.gzip.compress(data, args.level, writer=out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
