"""Core public types for zippy_tpu_torch (a copy of zippy_tpu.common, so the
port imports nothing of the JAX package), plus the port's device choice.

Parity reference: zippy's src/zippy/common.nim (ZippyError common.nim:2,
CompressedDataFormat common.nim:4-5, level constants common.nim:8-12).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from . import profiling


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


def upload_packed(payloads, device) -> tuple[list, list]:
    """Each payload (bytes-like) as a 1-D uint8 tensor on `device`, all from
    one upload with no host sync, counted in `upload.bytes`. The payloads
    lie at 16-byte aligned offsets of one host buffer, so that K2 reads each
    in place; for a card the buffer is pinned and returned in keep, to hold
    until the caller next synchronizes. Returns (tensors, keep)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    offs, total = [], 0
    for p in payloads:
        offs.append(total)
        total += -(-len(p) // 16) * 16
    host = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=cuda)
    h = host.numpy()
    for off, p in zip(offs, payloads):
        h[off:off + len(p)] = np.frombuffer(p, np.uint8)
    profiling.count("upload.bytes", total)
    buf = host.to(dev, non_blocking=True)
    return [buf[off:off + len(p)] for off, p in zip(offs, payloads)], (
        [host] if cuda else [])


def payload_tensors(payloads, device) -> tuple[list, list]:
    """Each payload as a 1-D uint8 tensor on `device` (a torch.device with
    its index, as resolve_devices gives it). A tensor there is read
    where it lies; a tensor elsewhere is copied there once, counted in
    `upload.bytes` when it comes from the host; the bytes-like and str
    (UTF-8) payloads go together in one upload (upload_packed). A tensor
    that is not 1-D uint8 raises ZippyError before any copy. Returns
    (tensors, keep), keep as upload_packed's."""
    payloads = [p.encode("utf-8") if isinstance(p, str) else p
                for p in payloads]
    for p in payloads:
        if isinstance(p, torch.Tensor):
            as_u8_tensor(p)             # the dtype and rank, checked
    hosted = [i for i, p in enumerate(payloads)
              if not isinstance(p, torch.Tensor)]
    views, keep = (upload_packed([payloads[i] for i in hosted], device)
                   if hosted else ([], []))
    out = list(payloads)
    for i, view in zip(hosted, views):
        out[i] = view
    for i, p in enumerate(out):
        if p.device != device:
            if p.device.type == "cpu":
                profiling.count("upload.bytes", p.nbytes)
            out[i] = p.to(device)
    return out, keep
