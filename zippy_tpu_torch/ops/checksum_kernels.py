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
    lib.zt_crc_combine.argtypes = [p, i64, i32, p, p, i32, p, p, i32]
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
                   total_padded: int) -> torch.Tensor:
    """adler32 of the first n bytes from the per-chunk residues of the
    zero-padded input (the tail of zippy_tpu's `_combine_chunks`), as a
    (1,) int64 tensor on their device, with no host sync. int64 sums of
    residues cannot overflow, so no interleaved mods are needed."""
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
    return ((s2 << 16) | s1).view(1)


# ---------------------------------------------------------------------------
# The crc tables
# ---------------------------------------------------------------------------

# Word offsets in the table buffer; csrc/checksums.cu has the same layout.
SLICE_WORDS = 16 * 256
LANE_WORDS = 32 * 4 * 256
SHIFT_OFFSET = SLICE_WORDS + LANE_WORDS
MAP_WORDS = 8 * 16         # one map's nibble tables
SHIFT_LEVELS = 25          # up to K3's Horner level 15 + COMBINE_MAX_LG
DISTANCE_MAPS = 512        # K3's distance maps, one per block of its grid
DISTANCE_OFFSET = SHIFT_OFFSET + SHIFT_LEVELS * MAP_WORDS


def _nibble_tables(cols: np.ndarray) -> np.ndarray:
    """(..., 32) uint32 columns of GF(2) maps -> (..., 8, 16) nibble
    tables, N[j][e] = M (e << 4j): M v is the XOR of N[j][(v >> 4j) & 15]
    over j."""
    e = np.arange(16, dtype=np.uint32)[:, None]
    bits = (e >> np.arange(4, dtype=np.uint32)) & 1          # (16, 4)
    c = cols.reshape(cols.shape[:-1] + (8, 1, 4))
    return np.bitwise_xor.reduce(c * bits, axis=-1)


def _distance_columns(unit_bytes: int, count: int) -> np.ndarray:
    """(count, 32) uint32: row d holds the columns of the shift over d
    units of `unit_bytes`; count is a power of two."""
    cols = checksums._shift_cols(0)[None]
    step = checksums._shift_cols(unit_bytes)
    while len(cols) < count:
        cols = np.concatenate([cols, checksums._apply_cols(step, cols)])
        step = checksums._apply_cols(step, step)
    return cols


@functools.cache
def _crc_tables() -> np.ndarray:
    """Every crc table, one uint32 buffer: the slice tables (16, 256), the
    lane tables (32, 4, 256), then as nibble tables of 128 words a map the
    shift levels (25, 8, 16), level b the shift over 2^b bytes, and K3's
    distance maps (512, 8, 16), map d the shift over d of its blocks."""
    levels = np.stack([checksums._shift_cols(1 << b)
                       for b in range(SHIFT_LEVELS)])
    return np.concatenate([
        checksums.crc_slice_tables().ravel(),
        checksums.crc_lane_tables().ravel(),
        _nibble_tables(levels).ravel(),
        _nibble_tables(_distance_columns(CRC_ROW_BYTES * COMBINE_THREADS,
                                         DISTANCE_MAPS)).ravel()])


@functools.cache
def _tables_on(device: torch.device) -> torch.Tensor:
    """The table buffer as int32 bit patterns on `device` (uploaded once)."""
    return torch.from_numpy(_crc_tables().view(np.int32).copy()).to(device)


def _tables_i64(device: torch.device):
    """The plain versions' view of the buffer, int64: (slice, lane, shift
    levels, distance maps)."""
    t = _tables_on(device).to(torch.int64) & 0xFFFFFFFF
    return (t[:SLICE_WORDS].view(16, 256),
            t[SLICE_WORDS:SHIFT_OFFSET].view(32, 4, 256),
            t[SHIFT_OFFSET:DISTANCE_OFFSET].view(SHIFT_LEVELS, 8, 16),
            t[DISTANCE_OFFSET:].view(DISTANCE_MAPS, 8, 16))


def _apply_nibbles(tabs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v for int64 32-bit words v, M given as (8, 16) nibble tables, or
    one map per word of a 1-D v as (len(v), 8, 16)."""
    j = torch.arange(8, device=v.device)
    idx = (v.unsqueeze(-1) >> (4 * j)) & 15
    if tabs.dim() == 2:
        return _xor_reduce(tabs[j, idx])
    return _xor_reduce(tabs.gather(-1, idx.unsqueeze(-1)).squeeze(-1))


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
    slice_t, lane_t, _, _ = _tables_i64(rows.device)
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

COMBINE_THREADS = 64     # K3's threads per block
COMBINE_MAX_LG = 9       # K3 runs at most 2^9 blocks (DISTANCE_MAPS)
COMBINE_MIN_STEPS = 4    # rows a lane, where the blocks allow
GROUP_LG = 5             # K3's blocks meet in groups of 2^5
COMBINE_SLOTS = 1024     # K3's sets of meeting words, one per stream
ROW_LEVEL = 9            # shift level of one row (2^9 bytes)
TREE_LEVELS = 6          # a block's tree: levels 9-14
BLOCK_LEVEL = ROW_LEVEL + TREE_LEVELS  # shift level of one block's rows


def _combine_lg(nfull: int) -> int:
    """log2 of K3's blocks: enough lanes for COMBINE_MIN_STEPS full rows
    each, at most 2^COMBINE_MAX_LG blocks."""
    lg = 0
    while (lg < COMBINE_MAX_LG
           and (COMBINE_THREADS << lg) * COMBINE_MIN_STEPS < nfull):
        lg += 1
    return lg


@functools.cache
def _last_columns(last_bytes: int) -> np.ndarray:
    """The shift over the last row's bytes as 32 uint32 columns."""
    return np.ascontiguousarray(checksums._shift_cols(last_bytes),
                                dtype=np.uint32)


_stream_slots: dict = {}


def _stream_slot(device: int, stream: int) -> int:
    """K3's meeting words for a stream: calls on one stream run one after
    another and share a set; each new stream takes a set of its own, so
    calls on two streams at once never share one. When all COMBINE_SLOTS
    sets are taken, a new stream raises ZippyError rather than share."""
    key = (device, stream)
    if key not in _stream_slots:
        if len(_stream_slots) >= COMBINE_SLOTS:
            raise ZippyError(f"crc_combine: all {COMBINE_SLOTS} stream slots "
                             "are taken; a new stream would share one")
        _stream_slots[key] = len(_stream_slots)
    return _stream_slots[key]


def crc_combine_plain(row_crcs: torch.Tensor,
                      last_bytes: int = CRC_ROW_BYTES) -> torch.Tensor:
    """Plain version of K3, step for step. Lattice: each of the L = 64 *
    2^lg lanes folds the full rows g, g + L, ... (zero rows in front) by
    Horner's rule. Tree: each block's 64 lane sums fold pairwise, at level
    k the left one shifted over 512 * 2^k bytes. Meeting: block b's sum
    shifted over the 2^lg - 1 - b blocks after it by its distance map,
    XORed in groups of 32, the groups' sums XORed; the whole shifted over
    the last row's `last_bytes` and XORed with that row's CRC. (1,) int32
    bit pattern."""
    _, _, lv, dist = _tables_i64(row_crcs.device)
    c = row_crcs.to(torch.int64) & 0xFFFFFFFF
    nfull = c.shape[0] - 1
    lg = _combine_lg(nfull)
    lanes = COMBINE_THREADS << lg
    steps = -(-nfull // lanes)
    lattice = torch.cat([c.new_zeros(steps * lanes - nfull),
                         c[:nfull]]).view(steps, lanes)
    acc = lattice[0] if steps else c.new_zeros(lanes)
    for j in range(1, steps):
        acc = _apply_nibbles(lv[BLOCK_LEVEL + lg], acc) ^ lattice[j]
    for k in range(TREE_LEVELS):
        acc = _apply_nibbles(lv[ROW_LEVEL + k], acc[0::2]) ^ acc[1::2]
    acc = _apply_nibbles(dist[(1 << lg) - 1 - torch.arange(
        1 << lg, device=c.device)], acc)
    groups = _xor_reduce(acc.view(-1, 1 << min(lg, GROUP_LG)))
    whole = _xor_reduce(groups)
    cols = torch.from_numpy(_last_columns(last_bytes).astype(np.int64))
    bits = (whole >> torch.arange(32, device=c.device)) & 1
    return _as_int32((_xor_reduce(cols.to(c.device) * bits)
                      ^ c[nfull]).view(1))


def crc_combine(row_crcs: torch.Tensor,
                last_bytes: int = CRC_ROW_BYTES) -> torch.Tensor:
    """Raw CRC of the whole from the raw CRCs of its rows: every row is 512
    bytes except the last, which has `last_bytes` (1..512). (n,) int32 ->
    (1,) int32 bit pattern. K3 on a CUDA tensor, the plain version on a
    CPU tensor.

    K3's blocks meet in a set of words kept per stream (`_stream_slot`),
    which every launch leaves zero. A CUDA graph that captures this call
    replays its capture stream's set: one captured graph must not replay
    on two streams at once, nor beside a call on its capture stream."""
    if (row_crcs.dtype != torch.int32 or row_crcs.dim() != 1
            or not row_crcs.numel() or not row_crcs.is_contiguous()):
        raise ZippyError("expected a non-empty contiguous 1-D int32 tensor")
    if not 1 <= last_bytes <= CRC_ROW_BYTES:
        raise ZippyError(f"last_bytes {last_bytes} is not in 1..512")
    if row_crcs.device.type == "cpu":
        return crc_combine_plain(row_crcs, last_bytes)
    if row_crcs.device.type != "cuda":
        raise ZippyError(f"unsupported device {row_crcs.device}")
    out = torch.empty(1, dtype=torch.int32, device=row_crcs.device)
    tables = _tables_on(row_crcs.device)
    device = row_crcs.device.index or 0
    stream = torch.cuda.current_stream(row_crcs.device).cuda_stream
    rc = _lib().zt_crc_combine(
        row_crcs.data_ptr(), row_crcs.numel(),
        _combine_lg(row_crcs.numel() - 1),
        tables.data_ptr() + 4 * SHIFT_OFFSET,
        _last_columns(last_bytes).ctypes.data, _stream_slot(device, stream),
        out.data_ptr(), stream, device)
    kernel_build.check_launch(rc, "crc_combine")
    LAUNCHES["crc_combine"] += 1
    return out
