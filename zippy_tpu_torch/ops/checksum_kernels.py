"""The checksum kernels (csrc/checksums.cu), their plain PyTorch versions,
and the combines around them.

Port of zippy_tpu/ops/pallas_checksums.py:

* K1 `adler_chunks` replaces the Pallas `_adler_tile_kernel`: per 1024-byte
  chunk, S = sum of bytes and W = sum (1024 - i) * byte_i, both mod 65521.
* K2 `crc_rows` replaces the kernel built by `_make_crc_tile_kernel`: per
  512-byte row, the raw CRC of the row, by byte-table lookups.
* K3 `crc_combine` replaces the jnp log tree `_crc_combine_rows`: one launch
  folds the row CRCs into the raw CRC of the whole.

The crc kernels read one table buffer (`_crc_tables`), built on the host
and kept on each device; the plain versions gather from the same tables.
A wrapper given a CUDA tensor launches its kernel (or raises); given a CPU
tensor it runs the plain version. The kernels build with nvcc at first CUDA
use into build/kernels/ (ops/kernel_build.py) and load through ctypes;
importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..common import ZippyError
from . import checksums, kernel_build
from .kernel_build import LAUNCHES

CHUNK = 1024               # adler bytes per chunk (W < 255 * 1024 * 1025 / 2 < 2^31)
CRC_ROW_BYTES = 512        # crc bytes per row: one warp of 16-byte vectors
MOD = checksums.ADLER_MOD


# ---------------------------------------------------------------------------
# Binding
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("checksums.cu")))
    except OSError as e:
        raise ZippyError(f"cannot load the checksum kernels: {e}") from e
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.zt_adler_chunks.argtypes = [p, i64, p, p, p, i32]
    lib.zt_crc_rows.argtypes = [p, i64, p, i32, p, p, p, i32]
    lib.zt_crc_combine.argtypes = [p, i64, i32, p, p, p, i32]
    for fn in (lib.zt_adler_chunks, lib.zt_crc_rows, lib.zt_crc_combine):
        fn.restype = i32
    return lib


def _check_input(x: torch.Tensor, width: int, align: int) -> None:
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != width:
        raise ZippyError(f"expected a (n, {width}) uint8 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ZippyError(f"kernel input must be contiguous and {align}-byte "
                         "aligned")
    if x.device.type not in ("cuda", "cpu"):
        raise ZippyError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# K1: adler32 per-chunk (S, W)
# ---------------------------------------------------------------------------


def adler_chunks_plain(chunks: torch.Tensor):
    """Plain version of K1: (nchunks, 1024) uint8 -> (S, W) int32 each."""
    d = chunks.to(torch.int64)
    w = CHUNK - torch.arange(CHUNK, dtype=torch.int64, device=chunks.device)
    s = d.sum(dim=1) % MOD
    wsum = (d * w).sum(dim=1) % MOD
    return s.to(torch.int32), wsum.to(torch.int32)


def adler_chunks(chunks: torch.Tensor):
    """Per-chunk adler residues: (nchunks, 1024) uint8 -> (S, W) int32 each.
    K1 on a CUDA tensor, the plain version on a CPU tensor."""
    _check_input(chunks, CHUNK, 16)
    if chunks.device.type == "cpu":
        return adler_chunks_plain(chunks)
    nchunks = chunks.shape[0]
    s = torch.empty(nchunks, dtype=torch.int32, device=chunks.device)
    w = torch.empty(nchunks, dtype=torch.int32, device=chunks.device)
    if nchunks:
        rc = _lib().zt_adler_chunks(
            chunks.data_ptr(), nchunks, s.data_ptr(), w.data_ptr(),
            torch.cuda.current_stream(chunks.device).cuda_stream,
            chunks.device.index or 0)
        kernel_build.check_launch(rc, "adler_chunks")
        LAUNCHES["adler_chunks"] += 1
    return s, w


def combine_chunks(s_c: torch.Tensor, w_c: torch.Tensor, n: int,
                   total_padded: int) -> int:
    """adler32 of the first n bytes from the per-chunk residues of the
    zero-padded input (the tail of zippy_tpu's `_combine_chunks`). int64
    sums of residues cannot overflow, so no interleaved mods are needed."""
    m = MOD
    s_c = s_c.to(torch.int64)
    w_c = w_c.to(torch.int64)
    nchunks = s_c.shape[0]
    off = ((nchunks - 1 - torch.arange(nchunks, device=s_c.device)) * CHUNK) % m
    w_padded = ((w_c + (off * s_c) % m) % m).sum() % m
    s_total = s_c.sum() % m
    # Zero padding sits at the END: every real byte's weight is inflated by
    # pad, so W_real = W_padded - pad * S  (mod m).
    pad = (total_padded - n) % m
    w_real = (w_padded + (m - (pad * s_total) % m)) % m
    s1 = (1 + s_total) % m
    s2 = (n % m + w_real) % m
    return int((s2 << 16) | s1)


# ---------------------------------------------------------------------------
# The crc tables
# ---------------------------------------------------------------------------

# Word offsets in the table buffer; csrc/checksums.cu has the same layout.
SLICE_WORDS = 16 * 256
LANE_WORDS = 32 * 4 * 256
SHIFT_LEVELS = 27
SHIFT_OFFSET = SLICE_WORDS + LANE_WORDS


@functools.cache
def _crc_tables() -> np.ndarray:
    """Every crc table, one uint32 buffer: the slice tables (16, 256), the
    lane tables (32, 4, 256) and the shift levels (27, 4, 256)."""
    return np.concatenate([checksums.crc_slice_tables().ravel(),
                           checksums.crc_lane_tables().ravel(),
                           checksums.crc_shift_tables(SHIFT_LEVELS).ravel()])


@functools.cache
def _tables_on(device: torch.device) -> torch.Tensor:
    """The table buffer as int32 bit patterns on `device` (uploaded once)."""
    return torch.from_numpy(_crc_tables().view(np.int32).copy()).to(device)


def _tables_i64(device: torch.device):
    """The plain versions' view of the buffer: (slice, lane, shift) int64."""
    t = _tables_on(device).to(torch.int64) & 0xFFFFFFFF
    return (t[:SLICE_WORDS].view(16, 256),
            t[SLICE_WORDS:SHIFT_OFFSET].view(32, 4, 256),
            t[SHIFT_OFFSET:].view(SHIFT_LEVELS, 4, 256))


def _apply_tables(tabs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v for int64 32-bit words v, M given as (4, 256) byte tables."""
    return (tabs[0][v & 255] ^ tabs[1][(v >> 8) & 255]
            ^ tabs[2][(v >> 16) & 255] ^ tabs[3][(v >> 24) & 255])


def _xor_reduce(v: torch.Tensor) -> torch.Tensor:
    """XOR over the last dimension, whose size is a power of two."""
    n = v.shape[-1]
    while n > 1:
        n //= 2
        v = v[..., :n] ^ v[..., n:2 * n]
    return v[..., 0]


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 32-bit words as int32 bit patterns."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


# ---------------------------------------------------------------------------
# K2: crc32 per-row raw CRC
# ---------------------------------------------------------------------------


def crc_rows_plain(rows: torch.Tensor, tail=None) -> torch.Tensor:
    """Plain version of K2: (nrows, 512) uint8 [+ a tail of < 512 bytes,
    front-padded to one more row] -> raw CRC per row, as int32 bit
    patterns. Each 16-byte lane slice by slice (D[15 - p] for its byte p),
    then each lane's shift tables, then the XOR of the 32 lanes."""
    if tail is not None and tail.numel():
        pad = torch.zeros(CRC_ROW_BYTES - tail.numel(), dtype=torch.uint8,
                          device=rows.device)
        rows = torch.cat([rows, torch.cat([pad, tail]).view(1, -1)])
    slice_t, lane_t, _ = _tables_i64(rows.device)
    b = rows.view(rows.shape[0], 32, 16).to(torch.int64)
    pos = torch.arange(15, -1, -1, device=rows.device)
    v = _xor_reduce(slice_t[pos, b])                      # (nrows, 32)
    lane = torch.arange(32, device=rows.device)
    v = (lane_t[lane, 0, v & 255] ^ lane_t[lane, 1, (v >> 8) & 255]
         ^ lane_t[lane, 2, (v >> 16) & 255] ^ lane_t[lane, 3, (v >> 24) & 255])
    return _as_int32(_xor_reduce(v))


def crc_rows(rows: torch.Tensor, tail=None) -> torch.Tensor:
    """Raw CRC of every 512-byte row: (nrows, 512) uint8 -> (nrows,) int32
    bit patterns. A non-empty `tail` (1-D uint8, < 512 bytes, same device)
    adds one more value: the raw CRC of the tail, which is that of the tail
    padded with zeros in front to a row. K2 on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check_input(rows, CRC_ROW_BYTES, 16)
    ntail = 0 if tail is None else tail.numel()
    if ntail and (tail.dtype != torch.uint8 or tail.dim() != 1
                  or ntail >= CRC_ROW_BYTES or tail.device != rows.device
                  or not tail.is_contiguous()):
        raise ZippyError("the tail must be a contiguous 1-D uint8 tensor of "
                         "fewer than 512 bytes on the rows' device")
    if rows.device.type == "cpu":
        return crc_rows_plain(rows, tail)
    nrows = rows.shape[0]
    out = torch.empty(nrows + (ntail > 0), dtype=torch.int32,
                      device=rows.device)
    if out.numel():
        rc = _lib().zt_crc_rows(
            rows.data_ptr(), nrows, tail.data_ptr() if ntail else None,
            ntail, out.data_ptr(), _tables_on(rows.device).data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream,
            rows.device.index or 0)
        kernel_build.check_launch(rc, "crc_rows")
        LAUNCHES["crc_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: the crc32 row fold
# ---------------------------------------------------------------------------

COMBINE_THREADS = 1024   # K3's threads per block
COMBINE_MAX_LG = 7       # K3 runs at most 2^7 blocks


def _combine_lg(nfull: int) -> int:
    """log2 of K3's blocks: enough threads for one full row each, at most
    2^7 blocks (csrc/checksums.cu, zt_crc_combine)."""
    lg = 0
    while lg < COMBINE_MAX_LG and (COMBINE_THREADS << lg) < nfull:
        lg += 1
    return lg


def crc_combine_plain(row_crcs: torch.Tensor,
                      last_bytes: int = CRC_ROW_BYTES) -> torch.Tensor:
    """Plain version of K3, step for step: each of the L = 1024 * 2^lg
    threads folds the full rows g, g + L, ... (zero rows in front) by
    Horner's rule and shifts its sum over the rows behind it; the XOR of
    the sums is shifted over the last row's `last_bytes` and XORed with
    that row's CRC. (1,) int32 bit pattern."""
    _, _, lv = _tables_i64(row_crcs.device)
    c = row_crcs.to(torch.int64) & 0xFFFFFFFF
    nfull = c.shape[0] - 1
    lg = _combine_lg(nfull)
    lanes = COMBINE_THREADS << lg
    steps = -(-nfull // lanes)
    lattice = torch.cat([c.new_zeros(steps * lanes - nfull),
                         c[:nfull]]).view(steps, lanes)
    acc = c.new_zeros(lanes)
    for j in range(steps):
        acc = _apply_tables(lv[19 + lg], acc) ^ lattice[j]
    behind = lanes - 1 - torch.arange(lanes, device=c.device)
    for b in range(10 + lg):
        acc = torch.where((behind >> b) & 1 == 1,
                          _apply_tables(lv[9 + b], acc), acc)
    f = _xor_reduce(acc)
    for b in range(10):
        if (last_bytes >> b) & 1:
            f = _apply_tables(lv[b], f)
    return _as_int32((f ^ c[nfull]).view(1))


def crc_combine(row_crcs: torch.Tensor,
                last_bytes: int = CRC_ROW_BYTES) -> torch.Tensor:
    """Raw CRC of the whole from the raw CRCs of its rows: every row is 512
    bytes except the last, which has `last_bytes` (1..512). (n,) int32 ->
    (1,) int32 bit pattern. K3 on a CUDA tensor, the plain version on a
    CPU tensor."""
    if (row_crcs.dtype != torch.int32 or row_crcs.dim() != 1
            or not row_crcs.numel() or not row_crcs.is_contiguous()):
        raise ZippyError("expected a non-empty contiguous 1-D int32 tensor")
    if not 1 <= last_bytes <= CRC_ROW_BYTES:
        raise ZippyError(f"last_bytes {last_bytes} is not in 1..512")
    if row_crcs.device.type == "cpu":
        return crc_combine_plain(row_crcs, last_bytes)
    if row_crcs.device.type != "cuda":
        raise ZippyError(f"unsupported device {row_crcs.device}")
    out = torch.zeros(1, dtype=torch.int32, device=row_crcs.device)
    tables = _tables_on(row_crcs.device)
    rc = _lib().zt_crc_combine(
        row_crcs.data_ptr(), row_crcs.numel(), last_bytes,
        tables.data_ptr() + 4 * SHIFT_OFFSET, out.data_ptr(),
        torch.cuda.current_stream(row_crcs.device).cuda_stream,
        row_crcs.device.index or 0)
    kernel_build.check_launch(rc, "crc_combine")
    LAUNCHES["crc_combine"] += 1
    return out
