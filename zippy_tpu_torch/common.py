"""Core public types for zippy_tpu_torch (a copy of zippy_tpu.common, so the
port imports nothing of the JAX package), plus the port's device choice.

Parity reference: zippy's src/zippy/common.nim (ZippyError common.nim:2,
CompressedDataFormat common.nim:4-5, level constants common.nim:8-12).
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class ZippyError(Exception):
    """The single exception type raised by every zippy_tpu_torch entry point.

    Contract (reference common.nim:2 + fuzz tests): malformed or truncated
    input must raise ZippyError — never crash, hang, or raise anything else.
    """


class CompressedDataFormat(enum.Enum):
    """Wire format for compress()/uncompress() (reference common.nim:4-5)."""

    DETECT = "detect"
    ZLIB = "zlib"
    GZIP = "gzip"
    DEFLATE = "deflate"


# Convenience aliases mirroring the reference's df* names.
dfDetect = CompressedDataFormat.DETECT
dfZlib = CompressedDataFormat.ZLIB
dfGzip = CompressedDataFormat.GZIP
dfDeflate = CompressedDataFormat.DEFLATE

# Compression levels (reference common.nim:8-12).
NoCompression = 0
BestSpeed = 1
BestCompression = 9
DefaultCompression = -1
HuffmanOnly = -2

VALID_LEVELS = tuple(range(-2, 10))


def check_level(level: int) -> int:
    if level not in VALID_LEVELS:
        raise ZippyError(f"Invalid compression level {level}")
    return level


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the CUDA card. Only
    an explicit "cpu" runs on the host (the plain PyTorch versions)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ZippyError("CUDA is not available; pass device='cpu' to run "
                         "the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ZippyError(f"unsupported device {dev}")
    return dev


def resolve_devices(devices) -> list[torch.device]:
    """A non-empty list of devices (a device may repeat), each resolved as
    resolve_device does. A CUDA device without an index gets the current
    one, so that per-device caches and launches never see an unindexed
    "cuda", which would mean whichever device is current at the time."""
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ZippyError("expected at least one device")
    return out


def host_bytes(data) -> bytes:
    """bytes, bytearray, memoryview or str (UTF-8) as bytes."""
    if isinstance(data, bytes):
        return data
    if isinstance(data, (bytearray, memoryview)):
        return bytes(data)
    if isinstance(data, str):
        return data.encode("utf-8")
    raise TypeError(f"Unsupported input type {type(data)!r}")


def as_u8_tensor(data, device=None) -> torch.Tensor:
    """The payload as a 1-D uint8 tensor: a tensor stays where it is; bytes,
    bytearray, memoryview or str (UTF-8) go to `device` in one upload."""
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8 or data.dim() != 1:
            raise ZippyError("expected a 1-D uint8 tensor")
        return data
    if isinstance(data, str):
        data = data.encode("utf-8")
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise TypeError(f"Unsupported input type {type(data)!r}")
    # One host copy into a tensor that owns writable memory, then at most
    # one upload.
    arr = np.frombuffer(data, dtype=np.uint8).copy()
    return torch.from_numpy(arr).to(resolve_device(device))
