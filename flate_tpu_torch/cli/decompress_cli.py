"""Differential decode of a raw deflate stream on stdin:

    python -m flate_tpu_torch.cli.decompress_cli [--device cuda|cpu] < FILE

Three decoders must agree on the bytes and on the error class: the
one-shot decode on the device, the streaming Decompressor on the device
read 977 bytes at a time (stream after stream while input remains), and
the plain versions on the CPU (device="cpu", a third
decoder by design, not a fallback).  Prints OK and the size, or ERR and
the error class.  Exit 0 on a clean decode, 1 on a protocol error (what
malformed input should give), 2 when the decoders disagree.
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flate-torch-decompress")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import flate_tpu_torch as ftt
    from flate_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)      # no card: raise, not an answer
    data = sys.stdin.buffer.read()

    def run(fn):
        try:
            return fn(), None
        except ftt.errors.FlateError as e:
            return None, type(e).__name__

    def streamed():
        d = ftt.flate.decompressor(data, device=dev)
        parts = []
        while not d.at_end():
            while chunk := d.read(977):
                parts.append(chunk)
            d.reset()
        return b"".join(parts)

    results = {
        "oneshot": run(lambda: ftt.flate.decompress(data, device=dev)),
        "stream": run(streamed),
        "cpu": run(lambda: ftt.flate.decompress(data, device="cpu")),
    }
    want = results["cpu"]
    for name, got in results.items():
        if got != want:
            print(f"DISAGREE {name}=({got[1]}) cpu=({want[1]})",
                  file=sys.stderr)
            return 2
    if want[1] is not None:
        print(f"ERR {want[1]}")
        return 1
    print(f"OK {len(want[0])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
