"""RFC 1952 gzip member writer (the port of zippy_tpu.gzip_format.write_member).

Parity reference: zippy's src/zippy/gzip.nim and zippy.nim:22-58 (member
write with random-length FNAME anti-oracle padding,
https://github.com/guzba/zippy/issues/61).
"""

from __future__ import annotations

import os
import struct

from . import engine
from .common import as_u8_tensor

GZIP_MAGIC = b"\x1f\x8b"

FNAME = 1 << 3


def write_member(
    src,
    level: int,
    *,
    random_name_padding: bool = True,
    engine_name: str = "auto",
    device=None,
) -> bytes:
    """One gzip member: header + deflate stream + crc32/ISIZE trailer.

    The payload goes to the device once (a tensor stays where it is): the
    deflate body and the crc32 both run there; only the ~20 header and
    trailer bytes assemble on the host."""
    engine.check_engine(engine_name)
    x = as_u8_tensor(src, device)
    flg = 0
    fields = b""
    if random_name_padding:
        # Random-length (0-25 chars) FNAME defeats compressed-length oracles.
        flg |= FNAME
        npad = os.urandom(1)[0] % 26
        fields += bytes(97 + i for i in range(npad)) + b"\x00"
    header = struct.pack("<2sBBIBB", GZIP_MAGIC, 8, flg, 0, 0, 0)
    body = engine.deflate(x, level, engine_name)
    trailer = struct.pack("<II", engine.crc32(x, engine_name),
                          int(x.shape[0]) & 0xFFFFFFFF)
    return header + fields + body + trailer
