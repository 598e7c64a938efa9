"""Kernel launch calls the host made while the innermost span was the
3-byte candidate pass and its merge (encode.match.k3) per encode.dispatch
span, that is per encode batch, in the traced window.  None where the
program records no pass spans inside encode.match (no encode.match.main
span in the window)."""

from gpubench.readers import ENCODE_OPS
from gpubench.spans import launches_per_span, read as table


def read(run):
    t = table(run) if run.mix["op"] in ENCODE_OPS else None
    if t is None or not t.count.get("encode.match.main"):
        return None
    return launches_per_span(run, ENCODE_OPS, ("encode.match.k3",),
                             "encode.dispatch")
