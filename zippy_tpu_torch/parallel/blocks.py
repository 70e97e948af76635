"""Block-parallel compression over a list of devices: the port of
zippy_tpu/parallel/blocks.py.

The reference runs its encoder under shard_map over a Mesh. Here each device
of a list (CUDA cards, or "cpu" for the plain versions; a device may repeat)
takes one contiguous run of blocks, gets one upload of that run with the
32 KiB history before it and PAD after it, and encodes it a group of
`_group_size` blocks at a time. Every device's next group is issued before
any is fetched, so cards work at once; the host then splices every block in
block order. That driver is `deflate_device.deflate_runs`, the one behind
`deflate_device.deflate` too, so the stream is byte-identical to it at any
device count.

The container checksums run on each device's contiguous share of whole
`block`-byte rows (kernels K2 + K3 for crc32, K1 for adler32); the host
fetches one value a device and combines them with `crc32_combine` or
`adler32_combine`. Empty input and level 0 are written by the host, as the
single-device encoder writes them, in the bytes of the reference's host
codec, to which the reference hands them; level -2 (which the reference
also hands to its host codec) runs the device encoder's literal-only
blocks here, and only decodes to the same payload.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..common import ZippyError, check_level, resolve_devices
from ..ops import checksums as cks
from ..ops import deflate_device as dd

_CK_BLOCK = 1 << 20  # 1 MiB checksum rows


def default_devices(n: int | None = None) -> list[torch.device]:
    """The first `n` CUDA cards (all of them for None). ZippyError when
    there is none: the plain versions run only on an explicit "cpu"."""
    if not torch.cuda.is_available():
        raise ZippyError("CUDA is not available; pass devices=['cpu'] to run "
                         "the plain PyTorch versions on the host")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())][:n]


def _devices(devices) -> list[torch.device]:
    return default_devices() if devices is None else resolve_devices(devices)


def _payload(data) -> np.ndarray:
    """Host bytes (bytes, bytearray, memoryview, or str as UTF-8) as a
    uint8 array, without a copy."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise TypeError(f"Unsupported input type {type(data)!r}")
    return np.frombuffer(data, dtype=np.uint8)


def deflate_sharded(data, level: int = 1, devices=None,
                    block_size: int = dd.BLOCK) -> bytes:
    """Raw DEFLATE stream of host bytes, its blocks encoded in contiguous
    runs, one a device (None: every CUDA card), with the per-block
    stored/fixed/dynamic choice: byte-identical to deflate_device.deflate
    of the same bytes at every device count."""
    devices = _devices(devices)
    check_level(level)
    x = torch.from_numpy(_payload(data).copy())
    return dd.deflate_runs(x, level, level, block_size, devices)


# ---------------------------------------------------------------------------
# Block-parallel container checksums (device compute + host combine)
# ---------------------------------------------------------------------------


def _shares(arr: np.ndarray, devices, block: int):
    """(device, its share) for each device whose contiguous share of whole
    `block`-byte rows is not empty; the shares are as even as the row count
    allows, and each is uploaded to its device."""
    n = len(arr)
    nrows = -(-n // block)
    bounds = [min(n, nrows * i // len(devices) * block)
              for i in range(len(devices) + 1)]
    return [(hi - lo, torch.from_numpy(arr[lo:hi].copy()).to(dev))
            for dev, lo, hi in zip(devices, bounds, bounds[1:]) if hi > lo]


def crc32_sharded(data, devices=None, block: int = _CK_BLOCK) -> int:
    """CRC-32 of host bytes, each device's share on that device (K2 + K3's
    raw CRC, one fetch a device), the shares combined on the host."""
    devices = _devices(devices)
    parts = [(nbytes, cks.crc32_raw_tensor(x))
             for nbytes, x in _shares(_payload(data), devices, block)]
    crc = 0
    for nbytes, raw in parts:
        crc = cks.crc32_combine(crc, cks.crc32_finish(int(raw), nbytes),
                                nbytes)
    return crc


def adler32_sharded(data, devices=None, block: int = _CK_BLOCK) -> int:
    """Adler-32 of host bytes, each device's share on that device (K1, one
    fetch a device), the shares combined on the host."""
    devices = _devices(devices)
    parts = [(nbytes, cks.adler32_tensor(x))
             for nbytes, x in _shares(_payload(data), devices, block)]
    adler = 1
    for nbytes, part in parts:
        adler = cks.adler32_combine(adler, int(part), nbytes)
    return adler


def compress_gzip_sharded(data, level: int = 1, devices=None) -> bytes:
    """gzip member whose deflate body and trailer crc32 are both computed
    block-parallel over the devices (the reference's header bytes: no
    FNAME, mtime 0)."""
    devices = _devices(devices)
    body = deflate_sharded(data, level, devices)
    crc = crc32_sharded(data, devices)
    header = struct.pack("<2sBBIBB", b"\x1f\x8b", 8, 0, 0, 0, 0)
    trailer = struct.pack("<II", crc, len(_payload(data)) & 0xFFFFFFFF)
    return header + body + trailer


def compress_zlib_sharded(data, level: int = 1, devices=None) -> bytes:
    """zlib stream, block-parallel body and adler32 trailer (the
    reference's header bytes, 78 01)."""
    devices = _devices(devices)
    body = deflate_sharded(data, level, devices)
    adler = adler32_sharded(data, devices)
    cmf = (7 << 4) | 8
    fcheck = (31 - (cmf * 256) % 31) % 31
    return bytes([cmf, fcheck]) + body + struct.pack(">I", adler)
