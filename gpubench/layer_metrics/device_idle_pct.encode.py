"""Device idle share of the traced encode window (%): 1 - the union of the
kernel, copy and set intervals over the window."""

from gpubench.readers import ENCODE_OPS, idle_pct


def read(run):
    return idle_pct(run, ENCODE_OPS)
