"""Public codec API of the port: compress() on the device pipeline.

Parity reference: zippy's src/zippy.nim (format framing) and
zippy_tpu.api.compress. Decompression is not ported yet.
"""

from __future__ import annotations

import struct

from . import engine, gzip_format
from .common import (
    CompressedDataFormat,
    DefaultCompression,
    ZippyError,
    as_u8_tensor,
    check_level,
    dfDeflate,
    dfGzip,
    dfZlib,
)


def compress(
    src,
    level: int = DefaultCompression,
    data_format: CompressedDataFormat = dfGzip,
    *,
    engine_name: str = "auto",
    device=None,
) -> bytes:
    """Compress src (bytes, bytearray, memoryview, str or a 1-D uint8
    tensor), framed per data_format (gzip by default).

    The payload is uploaded once to `device` (None: the CUDA card; "cpu"
    runs the plain PyTorch versions); a tensor stays on its own device. The
    deflate body and the trailer checksum both run there; only framing
    happens on the host."""
    check_level(level)
    engine.check_engine(engine_name)
    if data_format not in (dfGzip, dfZlib, dfDeflate):
        raise ZippyError(f"Invalid data format {data_format}")
    x = as_u8_tensor(src, device)

    if data_format == dfGzip:
        return gzip_format.write_member(x, level, engine_name=engine_name)
    body = engine.deflate(x, level, engine_name)
    if data_format == dfDeflate:
        return body
    cmf = (7 << 4) | 8                       # CINFO 7 (32 KiB window), CM 8
    header = bytes([cmf, (31 - (cmf * 256) % 31) % 31])
    return (header + body
            + struct.pack(">I", engine.adler32(x, engine_name)))
