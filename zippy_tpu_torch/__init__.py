"""zippy_tpu_torch: the PyTorch/CUDA port of zippy_tpu.

The device compress and decode paths (gzip, zlib and raw DEFLATE) on an
NVIDIA H100, with the checksum kernels and the decode's token extraction
hand-written in CUDA (csrc/checksums.cu, csrc/inflate.cu). Entry points run
on the CUDA card unless the caller passes device="cpu".
"""

from .api import compress, uncompress
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
    "compress", "uncompress", "CompressedDataFormat", "ZippyError",
    "dfDetect", "dfZlib", "dfGzip", "dfDeflate",
    "NoCompression", "BestSpeed", "BestCompression", "DefaultCompression",
    "HuffmanOnly",
]
