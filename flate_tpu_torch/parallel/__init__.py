"""Data-parallel compression over several processes, one device each.

Counterpart of flate_tpu/parallel/: the input splits into independent
128 KiB shards laid over a 1-D `torch.distributed` device mesh named
"shards" (one process a device), with

  (a) static shard -> rank placement (the batch axis cut into per-rank
      rows),
  (b) the 32 KiB context tail of each rank's last shard sent to the next
      rank (the JAX package's ppermute),
  (c) per-shard compressed lengths and bytes gathered in rank order, and
      CRC32 / Adler32 combined across shards on the host.

mesh2.compress_mesh2 is the single-program encode laid over the mesh;
pigz.compress_mesh is the round-1 pipeline (device/pipeline.py) laid over
it, one shard a rank a step; distributed.py joins the processes
(torchrun) and splits the stream into per-rank regions.
"""

from .pigz import combined_crc32, compress_mesh, make_mesh  # noqa: F401
