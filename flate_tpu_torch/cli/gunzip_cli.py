"""gunzip CLI on the device decoder:

    python -m flate_tpu_torch.cli.gunzip_cli [-o OUT] [-c]
        [--device cuda|cpu] FILE.gz       -> FILE (or OUT, or stdout)

Streams the file through flate_tpu_torch.gzip.decompress(reader, writer):
the streaming Decompressor, member after member, in bounded memory.
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
    if args.stdout:
        out, close = sys.stdout.buffer, False
    else:
        path = args.output or (args.file[:-3] if args.file.endswith(".gz")
                               else args.file + ".out")
        out, close = open(path, "wb"), True
    try:
        with open(args.file, "rb") as f:
            ftt.gzip.decompress(f, writer=out, device=args.device)
    finally:
        if close:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
