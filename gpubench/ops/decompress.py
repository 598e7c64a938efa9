"""One-shot decompress: `<container>.decompress(stream, batch)` on the
stream of each pool input in turn, made at set-up by the configuration's
producer; the answer is the decoded bytes.

Checked once the window has closed: every answer of the window equals its
input (bytes_wrong), and the same call on the stream of input 0 with one
bit of its stored checksum flipped raises the container's checksum error
(checksum_missed).  The control decodes with verify=False, which gives the
checksum up."""

from __future__ import annotations

from . import make_stream, namespace, output_checks, probe_checksum


def prepare(prog, cfg, mix, inputs, device, control):
    ns = namespace(prog, cfg)
    streams = [make_stream(prog, cfg, d, device) for d in inputs]

    def decode(stream):
        return ns.decompress(stream, verify=not control,
                             batch=cfg["decode_batch"], device=device)
    return {"decode": decode, "streams": streams, "cfg": cfg}


def call(state, k):
    return state["decode"](state["streams"][k])


def sizes(state, k, answer):
    return len(state["streams"][k]), len(answer)


def after_window(state):
    return {"checksum_missed": probe_checksum(
        state["decode"], state["streams"][0], state["cfg"]["container"])}


def check(cfg, mix, inputs, calls, after, seed):
    return {**output_checks(inputs, calls),
            "checksum_missed": (after["checksum_missed"], 0)}
