"""Public surface of the PyTorch port.

    import flate_tpu_torch as ftt
    blob = ftt.gzip.compress(data, level=6)              # on the CUDA card
    blob = ftt.zlib.compress(data, level=3, device="cpu")
    data = ftt.gzip.decompress(blob)                     # on the CUDA card
    data = ftt.gzip.decompress(blob, device="cpu", walk="serial")

Each namespace runs the one-shot device encode (device/pipeline2.py,
levels 1-9) and the device decode
(device/inflate2.py, device/anyinflate.py) with its container.
"""

from __future__ import annotations

import torch

from . import consts
from .containers import Container
from .device import anyinflate, inflate2, pipeline2, resolve_device


class _Namespace:
    def __init__(self, container: Container):
        self._container = container

    def compress(self, data: bytes, level: int = consts.LEVEL_DEFAULT, *,
                 device: str | torch.device = "cuda",
                 shard_len: int = consts.SHARD_LEN,
                 batch: int = 64) -> bytes:
        """Compress `data` at level 1-9 into one member of this container,
        in batches of `batch` shards of `shard_len` bytes."""
        return pipeline2.compress_device2(
            bytes(data), level=level, container=self._container,
            shard_len=shard_len, batch=batch, device=device)

    def decompress(self, data: bytes, *,
                   device: str | torch.device = "cuda", batch: int = 8,
                   walk: str | None = None) -> bytes:
        """Decompress a stream of this container on `device`.

        Members that carry the encoder's FLT1 shard index decode
        shard-parallel, `batch` shards at a time (device/inflate2.py).  A
        member without a usable index (a foreign encoder's stream, zlib
        and raw streams, or shards over 128 KiB) decodes on the same
        device as one chain of blocks from bit 0
        (device/anyinflate.py).  There is no host decoder to fall back
        to, and the decode never leaves the named device on its own: a
        missing card raises DeviceUnavailable.

        walk: "lanes" (lane walk with join resolve) or "serial" (exact
        serial walk) for the indexed decode; None reads
        FLATE_TPU_INFLATE_WALK from the environment at call time and
        defaults to "lanes".  Checksums and sizes are verified; corrupt
        input raises the errors of flate_tpu_torch.errors."""
        dev = resolve_device(device)
        data = bytes(data)
        try:
            return inflate2.decompress_device(
                data, self._container, batch=batch, device=dev, walk=walk)
        except LookupError:
            return anyinflate.decompress_device_any(
                data, self._container, device=dev)


gzip = _Namespace(Container.GZIP)
zlib = _Namespace(Container.ZLIB)
flate = _Namespace(Container.RAW)
