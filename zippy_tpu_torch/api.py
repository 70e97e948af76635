"""Public codec API of the port: compress() and uncompress() on the device
pipeline.

Parity reference: zippy's src/zippy.nim (format framing, dfDetect sniffing
zippy.nim:109-125, zlib CMF/FLG/FDICT checks zippy.nim:130-150) and
zippy_tpu.api (compress; uncompress with engine_name="device").
"""

from __future__ import annotations

import struct

import torch

from . import engine, gzip_format
from .common import (
    CompressedDataFormat,
    DefaultCompression,
    ZippyError,
    as_u8_tensor,
    check_level,
    dfDeflate,
    dfDetect,
    dfGzip,
    dfZlib,
    resolve_device,
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
    happens on the host. Level -1 runs level 6's matcher on host bytes and
    level 1's on a tensor, as zippy_tpu's device route does."""
    check_level(level)
    engine.check_engine(engine_name)
    if data_format not in (dfGzip, dfZlib, dfDeflate):
        raise ZippyError(f"Invalid data format {data_format}")
    if data_format == dfGzip:
        return gzip_format.write_member(src, level, engine_name=engine_name,
                                        device=device)
    x = as_u8_tensor(src, device)
    body = engine.deflate(x, level, engine_name,
                          engine.matcher_level(src, level))
    if data_format == dfDeflate:
        return body
    cmf = (7 << 4) | 8                       # CINFO 7 (32 KiB window), CM 8
    header = bytes([cmf, (31 - (cmf * 256) % 31) % 31])
    return (header + body
            + struct.pack(">I", engine.adler32(x, engine_name)))


def _looks_gzip(data: bytes) -> bool:
    return (
        len(data) > 18
        and data[0] == 31
        and data[1] == 139
        and data[2] == 8
        and (data[3] & 0b1110_0000) == 0
    )


def _looks_zlib(data: bytes) -> bool:
    return (
        len(data) > 6
        and (data[0] & 0x0F) == 8
        and (data[0] >> 4) <= 7
        and (data[0] * 256 + data[1]) % 31 == 0
    )


def _to_bytes(src) -> bytes:
    """The compressed stream on the host, where the decode's scan reads it."""
    if isinstance(src, bytes):
        return src
    if isinstance(src, (bytearray, memoryview)):
        return bytes(src)
    if isinstance(src, str):
        return src.encode("utf-8")
    if isinstance(src, torch.Tensor):
        return as_u8_tensor(src).cpu().numpy().tobytes()
    raise TypeError(f"Unsupported input type {type(src)!r}")


def uncompress(
    src,
    data_format: CompressedDataFormat = dfDetect,
    *,
    engine_name: str = "auto",
    device=None,
) -> bytes:
    """Uncompress src (bytes, bytearray, memoryview, str or a 1-D uint8
    tensor); detects gzip/zlib framing by default. Every gzip member is
    decoded and the payloads concatenated.

    "auto" and "device" both run the device decode (ops/inflate_device: one
    host scan of the stream, then the tiled decode on `device`; None means
    the CUDA card, "cpu" runs the plain PyTorch versions). Malformed or
    corrupt input raises ZippyError."""
    engine.check_engine(engine_name)
    dev = resolve_device(device)
    data = _to_bytes(src)
    if data_format == dfDetect:
        if _looks_gzip(data):
            data_format = dfGzip
        elif _looks_zlib(data):
            data_format = dfZlib
        else:
            raise ZippyError("Unable to detect compressed data format")
    if data_format == dfGzip:
        return gzip_format.uncompress_gzip_device_all(data, dev)
    if data_format == dfZlib:
        from .ops import inflate_device

        return inflate_device.uncompress_zlib_device(data, device=dev)
    if data_format == dfDeflate:
        return engine.inflate(data, 0, engine_name, dev)[0]
    raise ZippyError(f"Invalid data format {data_format}")
