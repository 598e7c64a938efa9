"""Which lanes of the lane walk stay unjoined, on one CUDA card.

    python3 tools/lane_join_probe.py [--level 1] [--level 3]

Encodes chip_smoke.py's text corpus at each level, takes its shards in
decode batches of 8, and for J in (96, 192, 384, 1024) runs the lane walk
kernel and _extract.  Prints, per batch, whether the kernel equals its
plain version at J = 96, and for every shard _extract flags as unproven:
its EOB lane, the unjoined lanes up to it, and the histogram of `adv` in
the first of them.  A lane that stays unjoined for every J is not short of
join steps: its chains never meet.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import S, smi, text_corpus  # noqa: E402
from flate_tpu_torch import api  # noqa: E402
from flate_tpu_torch.containers import Container, parse_header  # noqa: E402
from flate_tpu_torch.device import inflate2  # noqa: E402
from flate_tpu_torch.shard_index import parse_index_extra  # noqa: E402

G = inflate2.LANE_G


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, action="append")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(smi())
    text = text_corpus(3_359_630)
    for level in args.level or [1, 3]:
        blob = api.gzip.compress(text, level=level)
        hdr, meta = parse_header(Container.GZIP, blob)
        comp_lens, out_lens, _ = parse_index_extra(meta.extra)
        shards, off = [], hdr
        for c, o in zip(comp_lens, out_lens):
            shards.append((blob[off:off + int(c)], int(o)))
            off += int(c)
        for i in range(0, len(shards), 8):
            run = [(inflate2.plan_shard(sh, o), sh)
                   for sh, o in shards[i:i + 8]]
            a = inflate2.pack_coded_run(run, b"", dev)
            word = inflate2._pass1(a[0], *a[3:9])
            nbits = 8 * a[1]
            pm, pj = inflate2._lane_walk_plain(word, a[2], nbits, G, 96)
            for J in (96, 192, 384, 1024):
                m, j = inflate2._lane_walk(word, a[2], nbits, J=J)
                if J == 96:
                    same = bool((pm == m).all()) and bool((pj == j).all())
                    print(f"level {level} shards {i}-{i + len(run) - 1}: "
                          f"kernel == plain: {same}")
                ex = inflate2._extract(word, m, j, a[2], S + 128)
                fail = ex[2].cpu().numpy()
                unjoined = (~j).cpu().numpy()
                end_bit = ex[5].cpu().numpy()
                for b in range(len(run)):
                    if not fail[b]:
                        continue
                    le = int(end_bit[b]) // G
                    bad = [l for l in range(le + 1) if unjoined[b, l]]
                    line = (f"  J={J} shard {i + b}: has_eob "
                            f"{bool(ex[3][b])}, EOB lane {le}, unjoined "
                            f"lanes up to it {bad[:10]}")
                    if J == 96 and bad:
                        adv = (word[b, bad[0] * G:(bad[0] + 1) * G] & 63
                               ).cpu().numpy()
                        hist = {int(k): int((adv == k).sum())
                                for k in sorted(set(adv.tolist()))}
                        line += f"; adv histogram of lane {bad[0]}: {hist}"
                    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
