"""zippy_tpu_torch: the PyTorch/CUDA port of zippy_tpu.

The device compress and decode paths (gzip, zlib and raw DEFLATE) on an
NVIDIA H100, with the checksum kernels and the decode's token extraction
hand-written in CUDA (csrc/checksums.cu, csrc/inflate.cu), and the indexed
gzip formats: ZT member lengths (compress_indexed, uncompress_parallel) and
ZX decode-index sidecars, decoded with no host scan (compress_device_indexed,
uncompress_device). Entry points run on the CUDA card unless the caller
passes device="cpu".
"""

from .api import compress, uncompress
from .gzip_format import (
    compress_device_indexed,
    compress_indexed,
    uncompress_device,
    uncompress_parallel,
)
from .common import (
    BestCompression,
    BestSpeed,
    CompressedDataFormat,
    DefaultCompression,
    HuffmanOnly,
    NoCompression,
    ZippyError,
    dfDeflate,
    dfDetect,
    dfGzip,
    dfZlib,
)

__all__ = [
    "compress", "uncompress", "compress_indexed", "uncompress_parallel",
    "compress_device_indexed", "uncompress_device", "CompressedDataFormat",
    "ZippyError",
    "dfDetect", "dfZlib", "dfGzip", "dfDeflate",
    "NoCompression", "BestSpeed", "BestCompression", "DefaultCompression",
    "HuffmanOnly",
]
