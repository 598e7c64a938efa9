"""Device idle share of the traced encode window (%) while the innermost
program span was the match stage (encode.match: the priming of the
windows) or one of its passes: the main candidate pass
(encode.match.main), the 3-byte pass of levels 7-9 and its merge
(encode.match.k3), and the small-distance runs, chain extension and drop
(encode.match.extend)."""

from gpubench.readers import ENCODE_OPS
from gpubench.spans import idle_pct

MATCH = ("encode.match", "encode.match.main", "encode.match.k3",
         "encode.match.extend")


def read(run):
    return idle_pct(run, ENCODE_OPS, MATCH)
