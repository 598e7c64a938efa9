"""Device idle share of the traced decode window (%) while the innermost
program span was the indexed route's host planning: the header and FLT1
index (decode.index), the batch's plan_shard calls (decode.plan) and the
packing and upload of its coded run (decode.upload)."""

from gpubench.readers import DECODE_OPS
from gpubench.spans import idle_pct


def read(run):
    return idle_pct(run, DECODE_OPS,
                    ("decode.index", "decode.plan", "decode.upload"))
