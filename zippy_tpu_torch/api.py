"""Public codec API of the port: compress() and uncompress(), on the device
pipeline or, with engine_name="native", on the host engine.

Parity reference: zippy's src/zippy.nim (format framing, dfDetect sniffing
zippy.nim:109-125, zlib CMF/FLG/FDICT checks zippy.nim:130-150) and
zippy_tpu.api.
"""

from __future__ import annotations

import struct

import torch

from . import engine, gzip_format, native, profiling
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
    host_bytes,
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
    level 1's on a tensor, as zippy_tpu's device route does.

    engine_name="native" runs host bytes on the host engine (native.py),
    as zippy_tpu's host route does: raw DEFLATE and zlib in one call each,
    gzip through write_member; `device` is then unused. A tensor runs on
    its own device whatever the engine. With tracing on, the call keeps a
    record of its spans and counters (profiling.recent)."""
    with profiling.call("compress"):
        return _compress(src, level, data_format, engine_name, device)


def _compress(src, level, data_format, engine_name, device) -> bytes:
    check_level(level)
    engine.check_engine(engine_name)
    if data_format not in (dfGzip, dfZlib, dfDeflate):
        raise ZippyError(f"Invalid data format {data_format}")
    if data_format == dfGzip:
        return gzip_format.write_member(src, level, engine_name=engine_name,
                                        device=device)
    if engine.on_host(src, engine_name):
        data = host_bytes(src)
        if data_format == dfZlib:
            return native.zlib_compress(data, level)
        return native.deflate(data, level)
    x = as_u8_tensor(src, device)
    body = engine.deflate(x, level, engine_name,
                          engine.matcher_level(src, level))
    if data_format == dfDeflate:
        return body
    adler = engine.adler32(x, engine_name)
    with profiling.span("framing"):
        cmf = (7 << 4) | 8                   # CINFO 7 (32 KiB window), CM 8
        header = bytes([cmf, (31 - (cmf * 256) % 31) % 31])
        return header + body + struct.pack(">I", adler)


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
    """The compressed stream on the host, where the decode's scan and the
    host engine read it."""
    if isinstance(src, torch.Tensor):
        return as_u8_tensor(src).cpu().numpy().tobytes()
    return host_bytes(src)


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
    the CUDA card, "cpu" runs the plain PyTorch versions). "native" runs
    the host engine (native.py) on the stream's bytes, as zippy_tpu's host
    route does, whatever `src` is; `device` is then unused. Malformed or
    corrupt input raises ZippyError. With tracing on, the call keeps a
    record of its spans and counters (profiling.recent)."""
    with profiling.call("uncompress"):
        return _uncompress(src, data_format, engine_name, device)


def _uncompress(src, data_format, engine_name, device) -> bytes:
    engine.check_engine(engine_name)
    with profiling.span("framing"):
        data = _to_bytes(src)
    if engine_name == "native":
        return _uncompress_native(data, data_format)
    dev = resolve_device(device)
    if data_format == dfDetect:
        with profiling.span("framing"):
            data_format = _detect(data)
    if data_format == dfGzip:
        return gzip_format.uncompress_gzip_device_all(data, dev)
    if data_format == dfZlib:
        from .ops import inflate_device

        return inflate_device.uncompress_zlib_device(data, device=dev)
    if data_format == dfDeflate:
        return engine.inflate(data, 0, None, engine_name, dev)[0]
    raise ZippyError(f"Invalid data format {data_format}")


def _detect(data: bytes) -> CompressedDataFormat:
    if _looks_gzip(data):
        return dfGzip
    if _looks_zlib(data):
        return dfZlib
    raise ZippyError("Unable to detect compressed data format")


def _uncompress_native(data: bytes, data_format) -> bytes:
    """uncompress() on the host engine: zippy_tpu.api's host route, with
    its zlib header checks and their messages."""
    if data_format == dfDetect:
        data_format = _detect(data)
    if data_format == dfGzip:
        return gzip_format.uncompress_gzip(data)
    if data_format == dfZlib:
        if len(data) < 6:
            raise ZippyError("Invalid compressed data")
        cmf, flg = data[0], data[1]
        if (cmf & 0x0F) != 8:
            raise ZippyError("Unsupported compression method")
        if (cmf >> 4) > 7:
            raise ZippyError("Invalid compression info")
        if (cmf * 256 + flg) % 31 != 0:
            raise ZippyError("Invalid header")
        if flg & 0b0010_0000:
            raise ZippyError("Preset dictionary is not yet supported")
        return native.zlib_uncompress(data)
    if data_format == dfDeflate:
        return native.inflate(data)[0]
    raise ZippyError(f"Invalid data format {data_format}")
