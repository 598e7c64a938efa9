"""Device idle share of the traced encode window (%) while the innermost
program span was the squeeze (encode.squeeze, its greedy code lengths or
its cost DP): the host's time in the squeeze that the device waits on."""

from gpubench.readers import ENCODE_OPS
from gpubench.spans import idle_pct

SQUEEZE = ("encode.squeeze", "encode.squeeze.lengths", "encode.squeeze.dp")


def read(run):
    return idle_pct(run, ENCODE_OPS, SQUEEZE)
