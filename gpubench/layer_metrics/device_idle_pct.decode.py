"""Device idle share of the traced decode window (%): 1 - the union of the
kernel, copy and set intervals over the window."""

from gpubench.readers import DECODE_OPS, idle_pct


def read(run):
    return idle_pct(run, DECODE_OPS)
