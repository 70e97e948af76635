"""zippy_tpu_torch: the PyTorch/CUDA port of zippy_tpu.

The device compress path (gzip, zlib and raw DEFLATE) on an NVIDIA H100,
with the checksum kernels hand-written in CUDA (csrc/checksums.cu). Entry
points run on the CUDA card unless the caller passes device="cpu".
"""

from .api import compress
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
    "compress", "CompressedDataFormat", "ZippyError",
    "dfDetect", "dfZlib", "dfGzip", "dfDeflate",
    "NoCompression", "BestSpeed", "BestCompression", "DefaultCompression",
    "HuffmanOnly",
]
