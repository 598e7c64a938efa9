"""gunzip CLI on the device decoder:

    python -m flate_tpu_torch.cli.gunzip_cli [-o OUT] [-c]
        [--device cuda|cpu] FILE.gz       -> FILE (or OUT, or stdout)

Reads the whole member and decodes it with flate_tpu_torch.gzip.decompress
(shard-parallel where the member carries the FLT1 index).
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flate-torch-gunzip")
    ap.add_argument("file")
    ap.add_argument("-o", "--output")
    ap.add_argument("-c", "--stdout", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import flate_tpu_torch as ftt
    with open(args.file, "rb") as f:
        data = ftt.gzip.decompress(f.read(), device=args.device)
    if args.stdout:
        sys.stdout.buffer.write(data)
        return 0
    path = args.output or (args.file[:-3] if args.file.endswith(".gz")
                           else args.file + ".out")
    with open(path, "wb") as out:
        out.write(data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
