"""The device decode's host scan (zt_inflate_scan of csrc/zippy_native.cpp,
the host engine's library) through ctypes.

The port's own copy of zippy_tpu.native.inflate_scan: the library is built
with the host C++ compiler at first use (ops/kernel_build.py), on a CPU-only
host as on the card's, and the scan runs on the host.
"""

from __future__ import annotations

import numpy as np

from .. import native, profiling
from ..common import ZippyError

_ERR_DST_FULL = -2


def inflate_scan(data: bytes, start_bit: int, every: int) -> dict:
    """One-time decode-index scan of the raw DEFLATE stream that starts at
    bit `start_bit` of `data`. Returns numpy arrays: segments [nseg, 6]
    (bit_offset, out_offset, block_id, ntok, match_bytes, max copy-nesting
    depth), stored [nsto, 3] (src_byte, out_offset, len), block_lens
    [nblk, 318] (litlen 288 + dist 30 code lengths); and total_out, end_bit,
    max_depth (saturating at 0xFFFF), adler (of the whole output) and
    every. Offsets are absolute in `data`. Raises ZippyError on a malformed
    stream. Each call of zt_inflate_scan counts in `scan.passes`."""
    with profiling.span("scan"):
        return _scan(bytes(data), start_bit, every)


def _scan(data: bytes, start_bit: int, every: int) -> dict:
    if every < 1 or start_bit < 0:
        raise ZippyError("Invalid compressed data")
    lib = native._lib()
    # Sized from the bytes from start_bit on (a member of a long stream
    # needs no more) and left unfilled: the scan writes every row it
    # counts, and only those are read. A stream that needs more takes the
    # exact sizes from a second call.
    seg_cap = max(1024, 2 * max(len(data) - start_bit // 8, 0) // every)
    sto_cap, blk_cap = 256, 256
    while True:
        seg = np.empty((seg_cap, 6), np.int64)
        sto = np.empty((sto_cap, 3), np.int64)
        lens = np.empty((blk_cap, 318), np.uint8)
        counts = np.zeros(7, np.int64)
        profiling.count("scan.passes")
        rc = lib.zt_inflate_scan(
            data, len(data), start_bit, every, seg.ctypes.data, seg_cap,
            sto.ctypes.data, sto_cap, lens.ctypes.data, blk_cap,
            counts.ctypes.data)
        if rc == 0:
            nseg, nsto, nblk = (int(c) for c in counts[:3])
            return {
                "segments": seg[:nseg].copy(),
                "stored": sto[:nsto].copy(),
                "block_lens": lens[:nblk].copy(),
                "total_out": int(counts[3]),
                "end_bit": int(counts[4]),
                "max_depth": int(counts[5]),
                "adler": int(counts[6]),
                "every": every,
            }
        if rc == _ERR_DST_FULL:  # counts hold the exact sizes
            seg_cap = max(int(counts[0]), 1)
            sto_cap = max(int(counts[1]), 1)
            blk_cap = max(int(counts[2]), 1)
            continue
        raise ZippyError("Invalid compressed data")
