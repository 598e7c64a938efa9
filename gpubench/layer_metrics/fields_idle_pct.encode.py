"""Device idle share of the traced encode window (%) while the innermost
program span was the field build (encode.fields)."""

from gpubench.readers import ENCODE_OPS
from gpubench.spans import idle_pct


def read(run):
    return idle_pct(run, ENCODE_OPS, ("encode.fields",))
