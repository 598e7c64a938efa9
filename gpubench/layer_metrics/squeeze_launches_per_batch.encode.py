"""Kernel launch calls the host made inside the squeeze's spans (the
innermost span encode.squeeze, its greedy code lengths or its cost DP) per
encode.squeeze span, that is per encode batch, in the traced window."""

from gpubench.readers import ENCODE_OPS
from gpubench.spans import launches_per_span

SQUEEZE = ("encode.squeeze", "encode.squeeze.lengths", "encode.squeeze.dp")


def read(run):
    return launches_per_span(run, ENCODE_OPS, SQUEEZE, "encode.squeeze")
