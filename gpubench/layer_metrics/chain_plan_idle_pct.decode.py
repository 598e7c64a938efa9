"""Device idle share of the traced decode window (%) while the innermost
program span was the chained route's host work between rounds: planning
the frontier's blocks (chain.plan) and linking a round's rows into the
chain (chain.link)."""

from gpubench.readers import DECODE_OPS
from gpubench.spans import idle_pct


def read(run):
    return idle_pct(run, DECODE_OPS, ("chain.plan", "chain.link"))
