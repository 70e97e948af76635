"""Multi-device scale-out for zippy_tpu_torch: the port of zippy_tpu.parallel.

Data parallelism is block sharding over a list of devices (CUDA cards, or
"cpu" for the plain versions), the only strategy the DEFLATE format admits.
The multi-host layer is parallel.distributed (torch.distributed).
"""

from .blocks import (
    adler32_sharded,
    compress_gzip_sharded,
    compress_zlib_sharded,
    crc32_sharded,
    default_devices,
    deflate_sharded,
)

__all__ = [
    "deflate_sharded",
    "compress_gzip_sharded",
    "compress_zlib_sharded",
    "crc32_sharded",
    "adler32_sharded",
    "default_devices",
]
