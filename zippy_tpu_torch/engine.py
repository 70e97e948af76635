"""Codec engine selection for the port: the device routes of zippy_tpu.engine.

"auto" and "device" both run the device pipeline. "native" (the reference's
host C++ codec) is not part of the port and raises ZippyError. A tensor runs
on its own device; host bytes go to the CUDA card. The decode's host scan is
the port's own (ops/inflate_scan.py).
"""

from __future__ import annotations

import torch

from .common import ZippyError

_ENGINES = ("auto", "native", "device")


def check_engine(engine: str) -> None:
    """Reject typo'd engine names and the host codec, which the port lacks."""
    if engine not in _ENGINES:
        raise ZippyError(f"unknown engine {engine!r}; expected one of "
                         f"{_ENGINES}")
    if engine == "native":
        raise ZippyError("the native host codec is not part of "
                         "zippy_tpu_torch; use engine 'auto' or 'device'")


def matcher_level(src, level: int) -> int:
    """The matcher `level` runs for `src`, as zippy_tpu's device route picks
    it: host bytes run the level's own (level -1 as level 6), and a tensor
    runs level 1's at level -1 (zippy_tpu's deflate_array)."""
    return max(level, 1) if isinstance(src, torch.Tensor) else level


def deflate(data, level: int, engine: str = "auto",
            matcher: int | None = None) -> bytes:
    """Raw DEFLATE encode on the device pipeline. `matcher` is the level
    whose matcher runs (None: matcher_level(data, level)); a caller that
    uploaded host bytes itself passes matcher_level of those bytes."""
    from .ops import deflate_device

    check_engine(engine)
    if isinstance(data, torch.Tensor):
        return deflate_device.deflate_array(data, level, matcher=matcher)
    return deflate_device.deflate(data, level)


def inflate(data: bytes, start_bit: int = 0, engine: str = "auto",
            device=None) -> tuple[bytes, int]:
    """Raw DEFLATE decode on the device pipeline (ops/inflate_device: the
    host scan, then the tiled decode on `device`, None meaning the CUDA
    card). Returns (payload, end_bit)."""
    from .ops import inflate_device

    check_engine(engine)
    index = inflate_device.build_decode_index(data, start_bit)
    return (inflate_device.inflate_device(data, index, device=device),
            int(index["end_bit"]))


def crc32(data, engine: str = "auto") -> int:
    """CRC-32 on the device (kernel K2 on a CUDA tensor)."""
    from .ops import checksums

    check_engine(engine)
    return checksums.crc32_device(data)


def adler32(data, engine: str = "auto") -> int:
    """Adler-32 on the device (kernel K1 on a CUDA tensor)."""
    from .ops import checksums

    check_engine(engine)
    return checksums.adler32_device(data)
