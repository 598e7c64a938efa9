"""Lane-walk batches of the indexed route walked again serially (%):
decode.retry spans over decode.batch spans in the traced window."""

from gpubench.readers import DECODE_OPS
from gpubench.spans import count_pct


def read(run):
    return count_pct(run, DECODE_OPS, "decode.retry", "decode.batch")
