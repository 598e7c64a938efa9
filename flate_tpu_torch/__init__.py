"""flate_tpu_torch — the DEFLATE device encoder and decoder in PyTorch with
hand-written CUDA kernels for the H100 (a port of flate_tpu's JAX device
side).

    import flate_tpu_torch as ftt
    blob = ftt.gzip.compress(data, level=1)          # runs on "cuda"
    data = ftt.gzip.decompress(blob)                 # runs on "cuda"
    c = ftt.gzip.compressor(writer, level=6)         # streaming, on "cuda"
    d = ftt.gzip.decompressor(reader)                # streaming, on "cuda"
    ftt.metrics.enable(); ...; ftt.metrics.summary() # per-op GB/s

Entry points run on the CUDA card unless the caller passes device="cpu";
a missing card raises.  Kernels build with nvcc at first use.
"""

from . import errors, metrics
from .api import Compressor, Decompressor, flate, gzip, zlib
from .containers import Container, GzipMetadata

__all__ = ["gzip", "zlib", "flate", "Compressor", "Decompressor",
           "Container", "GzipMetadata", "errors", "metrics"]
