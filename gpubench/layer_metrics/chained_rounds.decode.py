"""Device rounds of the chained decode route a stream
(inflate2.STATS["chained_rounds"] over the traced window, per call)."""

from gpubench.readers import DECODE_OPS


def read(run):
    rounds = run.counters.get("inflate2.chained_rounds")
    if rounds is None or run.mix["op"] not in DECODE_OPS or not run.done:
        return None
    return rounds / len(run.done)
