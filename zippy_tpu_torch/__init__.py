"""zippy_tpu_torch: the PyTorch/CUDA port of zippy_tpu.

The device compress and decode paths (gzip, zlib and raw DEFLATE) on an
NVIDIA H100, with the checksum kernels and the decode's token extraction
hand-written in CUDA (csrc/checksums.cu, csrc/inflate.cu), and the indexed
gzip formats: ZT member lengths (compress_indexed, uncompress_parallel) and
ZX decode-index sidecars, decoded with no host scan (compress_device_indexed,
uncompress_device). The archive layer reads and writes zip files
(ZipArchiveReader, open_zip_archive, create_zip_archive, extract_all_zip;
the v1 ZipArchive) and tarballs (extract_all_tarball; the v1 Tarball,
create_tarball), with an archive's entries encoded together in shared
device groups and decoded in one dispatch pass. `parallel` spreads the
encode and the checksums over a list of devices and gathers members across
processes (torch.distributed); `profiling` traces a block; `warmup` takes
the first-call costs up front. Entry points run on the CUDA card unless
the caller passes device="cpu". engine_name="native" runs host bytes on the
host engine instead (native.py, the port's copy of zippy_tpu's C++ host
codec, built with the host compiler at first use); gzip_format's
read_member, uncompress_gzip and concat_members decode on it.
"""

from . import profiling
from .api import compress, uncompress
from .gzip_format import (
    compress_device_indexed,
    compress_indexed,
    uncompress_device,
    uncompress_parallel,
)
from .tarballs import extract_all as extract_all_tarball
from .tarballs_v1 import Tarball, TarballEntry, create_tarball
from .ziparchives import (
    ZipArchiveReader,
    create_zip_archive,
    extract_all as extract_all_zip,
    open_zip_archive,
)
from .ziparchives_v1 import ArchiveEntry, ZipArchive
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


def warmup(max_bytes: int = 16 << 20, levels=(1, -1), decode: bool = True,
           encode: bool = True, devices=None) -> int:
    """Take the device codec's first-call costs before a user's first call,
    on each of `devices` (None: every CUDA card; ["cpu"] the plain
    versions). PyTorch compiles no executables, so this stands for the
    reference's compiles: it builds the native libraries (nvcc and c++;
    for CPU devices only the host engine's, which holds the host scan),
    uploads the crc tables and the encoder's and decoder's constant tables
    to each device, then runs on each device one gzip compress per level
    (of up to two blocks) and one gzip decode of up to `max_bytes` (a
    stream over 2 MiB takes the large tile size). Returns the number of
    warm-up calls it ran."""
    import gzip

    import numpy as np

    from .common import resolve_devices
    from .ops import (checksum_kernels, deflate_device, device_tables,
                      inflate_device, inflate_kernels)
    from .ops import kernel_build
    from .parallel import default_devices

    devices = default_devices() if devices is None else resolve_devices(
        devices)
    if any(dev.type == "cuda" for dev in devices):
        kernel_build.build_all()
    else:
        kernel_build.build_all(kernel_build.HOST_SOURCES)
    small = inflate_device.CFG_S.tile_out * 8
    payload = np.random.default_rng(0).integers(
        97, 123, min(max_bytes, small + 1), dtype=np.uint8).tobytes()
    blob = gzip.compress(payload, 1) if decode else b""
    piece = payload[:2 * deflate_device.BLOCK]
    n = 0
    for dev in devices:
        checksum_kernels._tables_on(dev)
        for name in device_tables.CONSTS:
            device_tables.const(name, dev)
        inflate_kernels._entries(dev)
        if encode:
            for level in levels:
                compress(piece, level, dfGzip, device=dev)
                n += 1
        if decode:
            uncompress(blob, dfGzip, device=dev)
            n += 1
    return n


__version__ = "0.1.0"

__all__ = [
    "compress", "uncompress", "compress_indexed", "uncompress_parallel",
    "compress_device_indexed", "uncompress_device", "warmup", "profiling",
    "ZipArchiveReader", "open_zip_archive", "create_zip_archive",
    "extract_all_zip", "ZipArchive", "ArchiveEntry", "Tarball",
    "TarballEntry", "create_tarball", "extract_all_tarball",
    "CompressedDataFormat", "ZippyError",
    "dfDetect", "dfZlib", "dfGzip", "dfDeflate",
    "NoCompression", "BestSpeed", "BestCompression", "DefaultCompression",
    "HuffmanOnly", "__version__",
]
