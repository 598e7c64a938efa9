"""JAX references for tests/test_torch_fused.py, made in a process of their
own: the JAX package's single-jit program (pipeline2.encode_batch) is its
largest XLA:CPU compile, and a crash there must fail those tests, not the
worker that runs them (see tests/test_pipeline2.py, test_staged_equals_
fused).

    python tests/_torch_fused_ref.py OUT.npz LEVEL [LEVEL ...]

writes, per level L, the JAX encode_batch(interpret=True) outputs on
`batch_inputs()` (words{L} as uint32, tbits{L}, kind{L}) and the bytes of
compress_device2(fused=True, interpret=True, batch=3) on `fused_corpus()`
(gzip{L}; zlib{L} too at level 6), batch 3 so that the program compiled
for encode_batch serves every batch.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

from _torch_corpora import CTX, S, corpus, rfc_text  # noqa: E402

B = 3


def batch_inputs():
    """The three rows of tests/test_pipeline2.py's staged/fused check:
    rfc1951 text, no context on row 0, a ragged final row.  Returns
    numpy (shards, ctx0, ctx_lens, valid, finals)."""
    data = rfc_text()[:2 * S + 311]
    arr = np.frombuffer(data, dtype=np.uint8)
    shards = np.zeros((B, S), dtype=np.uint8)
    shards.reshape(-1)[:arr.size] = arr
    return (shards, np.zeros(CTX, dtype=np.uint8),
            np.array([0, CTX, CTX], dtype=np.int32),
            np.array([S, S, arr.size - 2 * S], dtype=np.int32),
            np.array([0, 0, 1], dtype=np.int32))


def fused_corpus() -> bytes:
    """Seven shards and a tail: three batches of 3, the last one short."""
    return corpus("text", 7 * S + 333, seed=2)


def main(out: str, levels: list[int]) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from flate_tpu.containers import Container
    from flate_tpu.jx import pipeline2

    res = {}
    args = [jnp.asarray(x) for x in batch_inputs()]
    data = fused_corpus()
    for L in levels:
        K, nw, lazy, max_lazy, K3, squeeze, blk = pipeline2.LEVEL_KERNEL[L]
        words, tbits, kind = pipeline2.encode_batch(
            *args, S=S, ctx=CTX, K=K, nw=nw, lazy=lazy, max_lazy=max_lazy,
            K3=K3, squeeze=squeeze, blk=min(blk, S), interpret=True)
        res[f"words{L}"] = np.asarray(words).astype(np.uint32)
        res[f"tbits{L}"] = np.asarray(tbits)
        res[f"kind{L}"] = np.asarray(kind)
        containers = [Container.GZIP] + ([Container.ZLIB] if L == 6 else [])
        for c in containers:
            blob = pipeline2.compress_device2(
                data, level=L, container=c, shard_len=S, ctx=CTX, batch=B,
                interpret=True, fused=True)
            res[f"{c.name.lower()}{L}"] = np.frombuffer(blob, np.uint8)
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1], [int(x) for x in sys.argv[2:]])
