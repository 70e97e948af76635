"""The two checksum kernels (csrc/checksums.cu), their plain PyTorch
versions, and the combines around them.

Port of zippy_tpu/ops/pallas_checksums.py:

* K1 `adler_chunks` replaces the Pallas `_adler_tile_kernel`: per 1024-byte
  chunk, S = sum of bytes and W = sum (1024 - i) * byte_i, both mod 65521.
* K2 `crc_rows` replaces the kernel built by `_make_crc_tile_kernel`: per
  row of 128 little-endian words (512 bytes), the raw CRC of the row.

A wrapper given a CUDA tensor launches its kernel (or raises); given a CPU
tensor it runs the plain version. The combines are torch ops on the tensor's
device. The kernels build with nvcc at first CUDA use into build/kernels/
and load through ctypes; importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import torch

from ..common import ZippyError
from . import checksums

CHUNK = 1024               # adler bytes per chunk (W < 255 * 1024 * 1025 / 2 < 2^31)
CRC_ROW = 128              # crc words per row
CRC_ROW_BYTES = 4 * CRC_ROW
MOD = checksums.ADLER_MOD

# Kernel launches per wrapper: one per launch, counted nowhere else.
LAUNCHES = {"adler_chunks": 0, "crc_rows": 0}

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "checksums.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise ZippyError("nvcc not found: the CUDA kernels build on first use")


def build() -> pathlib.Path:
    """Compile csrc/checksums.cu for sm_90a into build/kernels/ (skipped when
    a library built from the same source is there). Returns its path; the
    compiler's output, resource usage included, is beside it as .log."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    lib = BUILD_DIR / f"libzt_checksums-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise ZippyError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.zt_adler_chunks.argtypes = [p, i64, p, p, p, i32]
    lib.zt_adler_chunks.restype = i32
    lib.zt_crc_rows.argtypes = [p, i64, p, p, p, i32]
    lib.zt_crc_rows.restype = i32
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


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise ZippyError(f"{name} kernel launch failed: cudaError {rc}")


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
        _raise_on(rc, "adler_chunks")
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
# K2: crc32 per-row raw CRC
# ---------------------------------------------------------------------------


@functools.cache
def crc_matrices() -> np.ndarray:
    """(8, 32) uint32: row 0 = raw CRC of each bit of a little-endian word;
    row r (1..7) = the shift over 4 * 2^(r-1) bytes, which folds two halves
    of 2^(r-1) words each."""
    return np.ascontiguousarray(
        np.stack([checksums._word_bit_columns(), *checksums._tree_matrices(7)]),
        dtype=np.uint32)


def _gf2_apply(cols: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply one GF(2) matrix (32 int64 columns) to int64 32-bit words:
    32 select-XORs."""
    out = torch.zeros_like(v)
    for j in range(32):
        out ^= ((v >> j) & 1) * cols[j]
    return out


def crc_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (nrows, 512) uint8 -> raw CRC per row, as the
    int32 bit pattern. Each word's raw CRC, then contiguous halving folds:
    with h words per half, v_i <- shift^(4h)(v_i) ^ v_{i+h}."""
    mats = torch.from_numpy(crc_matrices().astype(np.int64)).to(rows.device)
    b = rows.to(torch.int64).view(rows.shape[0], CRC_ROW, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    v = _gf2_apply(mats[0], w)
    half, r = CRC_ROW // 2, 7
    while half:
        v = _gf2_apply(mats[r], v[:, :half]) ^ v[:, half:2 * half]
        half, r = half // 2, r - 1
    v = v[:, 0]
    return (v - ((v >> 31) << 32)).to(torch.int32)


def crc_rows(rows: torch.Tensor) -> torch.Tensor:
    """Raw CRC of every 512-byte row: (nrows, 512) uint8 -> (nrows,) int32
    bit patterns. K2 on a CUDA tensor, the plain version on a CPU tensor."""
    _check_input(rows, CRC_ROW_BYTES, 4)
    if rows.device.type == "cpu":
        return crc_rows_plain(rows)
    nrows = rows.shape[0]
    out = torch.empty(nrows, dtype=torch.int32, device=rows.device)
    if nrows:
        mats = crc_matrices()
        rc = _lib().zt_crc_rows(
            rows.data_ptr(), nrows, out.data_ptr(),
            mats.ctypes.data_as(ctypes.c_void_p),
            torch.cuda.current_stream(rows.device).cuda_stream,
            rows.device.index or 0)
        _raise_on(rc, "crc_rows")
        LAUNCHES["crc_rows"] += 1
    return out


def combine_rows(row_crcs: torch.Tensor, init_term: int) -> int:
    """crc32 from per-row raw CRCs (the log-tree of zippy_tpu's
    `_crc_combine_rows`, then the init term and the final xor). An odd
    level gets a zero row in front: leading zeros are free in raw space,
    so the row count need not be a power of two."""
    c = row_crcs.to(torch.int64) & 0xFFFFFFFF
    levels = max(1, (c.shape[0] - 1).bit_length())
    mats = torch.from_numpy(
        checksums._tree_matrices(max(28, 7 + levels)).astype(np.int64)
    ).to(c.device)
    k = 7  # a row is 2^7 words
    while c.shape[0] > 1:
        if c.shape[0] % 2:
            c = torch.cat([c.new_zeros(1), c])
        c = _gf2_apply(mats[k], c[0::2]) ^ c[1::2]
        k += 1
    return int(c[0]) ^ init_term ^ 0xFFFFFFFF
