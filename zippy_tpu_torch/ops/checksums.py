"""Device checksums: adler32 and crc32 as parallel reductions on the card.

Port of zippy_tpu/ops/checksums.py. The host GF(2) helpers are copied as
they are (numpy and Python ints). The device side is the two hand-written
CUDA kernels of ops/checksum_kernels.py:

* adler32 — each 1024-byte chunk contributes (S, W) = (sum d_i,
  sum (1024 - i) d_i) mod 65521 (kernel K1); the chunks combine
  associatively in a few torch ops.
* crc32 — CRC is GF(2)-linear: the register after message M with init I is
  shift8^n(I) XOR raw(M). Kernel K2 gives the raw CRC of every 512-byte row
  (the last, shorter row padded at its FRONT: leading zero bytes are free in
  raw space), and kernel K3 folds the rows into the raw CRC of the whole.
  Every GF(2) map on the card is 4 byte tables (`_byte_tables`).

A CUDA tensor stays on the card. `adler32_tensor` and `crc32_tensor` leave
the result there too, as a (1,) int64 tensor, so callers can batch their
fetches. `crc32_raw_tensor` leaves K3's raw CRC, with no work after K3:
`crc32_finish` turns its fetched value into the crc32 on the host, as
`crc32_device` does; `adler32_device` fetches adler32_tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import profiling
from ..common import as_u8_tensor, resolve_device

ADLER_MOD = 65521
CRC32_POLY = 0xEDB88320  # reflected polynomial

# ---------------------------------------------------------------------------
# Host-side GF(2) linear algebra (32x32 matrices as 32 uint32 columns)
# ---------------------------------------------------------------------------


@functools.cache
def _crc_byte_table() -> np.ndarray:
    """T0[b] = CRC register after one byte b with init 0 (standard table)."""
    table = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if (c & 1) else 0)
        table[b] = c
    return table.astype(np.uint32)


def gf2_matvec(mat: np.ndarray, vec: int) -> int:
    """Apply 32x32 GF(2) matrix (columns as uint32) to a 32-bit vector."""
    out = 0
    v = int(vec)
    for j in range(32):
        if (v >> j) & 1:
            out ^= int(mat[j])
    return out


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([gf2_matvec(a, int(col)) for col in b], dtype=np.uint32)


@functools.cache
def _shift8_matrix() -> bytes:
    """Matrix for one-byte CRC register advance: c -> (c>>8) ^ T0[c & 0xFF]."""
    t0 = _crc_byte_table()
    cols = np.zeros(32, dtype=np.uint32)
    for j in range(32):
        e = np.uint32(1 << j)
        cols[j] = (e >> np.uint32(8)) ^ t0[int(e) & 0xFF]
    return cols.tobytes()


@functools.cache
def _shift_matrix_pow(k: int) -> bytes:
    """shift8^(2^k) as a GF(2) matrix (advance register by 2^k bytes)."""
    if k == 0:
        return _shift8_matrix()
    m = np.frombuffer(_shift_matrix_pow(k - 1), dtype=np.uint32)
    return gf2_matmul(m, m).tobytes()


def crc_shift_register(value: int, nbytes: int) -> int:
    """Advance a CRC register by nbytes of (implicit) processing: shift8^n."""
    v = int(value)
    k = 0
    n = int(nbytes)
    while n:
        if n & 1:
            v = gf2_matvec(np.frombuffer(_shift_matrix_pow(k), dtype=np.uint32), v)
        n >>= 1
        k += 1
    return v


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32(A || B) from crc32(A), crc32(B), len(B).

    Register after A||B = shift^len2(reg_A) ^ raw(B); linearity cancels the
    init terms, leaving shift^len2(crc1) ^ crc2 (the zlib form)."""
    if len2 == 0:
        return crc1 & 0xFFFFFFFF
    return (crc_shift_register(crc1, len2) ^ crc2) & 0xFFFFFFFF


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """adler32(A || B) from the two part checksums (zlib adler32_combine)."""
    m = ADLER_MOD
    rem = len2 % m
    s1a, s2a = adler1 & 0xFFFF, (adler1 >> 16) & 0xFFFF
    s1b, s2b = adler2 & 0xFFFF, (adler2 >> 16) & 0xFFFF
    s1 = (s1a + s1b - 1) % m
    s2 = (s2a + s2b + rem * (s1a - 1)) % m  # s2b already counts len2 * 1 init
    return ((s2 << 16) | s1) & 0xFFFFFFFF


def _apply_cols(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Apply a GF(2) matrix (32 uint32 columns) to every uint32 of v."""
    v = np.asarray(v, dtype=np.uint32)
    out = np.zeros_like(v)
    for j in range(32):
        out ^= np.where((v >> np.uint32(j)) & np.uint32(1), cols[j],
                        np.uint32(0)).astype(np.uint32)
    return out


def _byte_tables(cols: np.ndarray) -> np.ndarray:
    """(4, 256) uint32 byte tables of a GF(2) map M: T[j][b] = M (b << 8j),
    so M v = T[0][v & 255] ^ T[1][(v >> 8) & 255] ^ ... (4 lookups)."""
    b = np.arange(256, dtype=np.uint32)
    return np.stack([_apply_cols(cols, b << np.uint32(8 * j))
                     for j in range(4)])


def _shift_cols(nbytes: int) -> np.ndarray:
    """shift8^nbytes as 32 uint32 columns (the identity for 0)."""
    m = np.array([1 << j for j in range(32)], dtype=np.uint32)
    k = 0
    while nbytes:
        if nbytes & 1:
            m = _apply_cols(np.frombuffer(_shift_matrix_pow(k), np.uint32), m)
        nbytes >>= 1
        k += 1
    return m


@functools.cache
def crc_slice_tables() -> np.ndarray:
    """(16, 256) uint32: D[k][b] = raw CRC of byte b followed by k zero
    bytes (slicing-by-16; D[:4] are zippy_tpu's `_crc_word_tables`)."""
    shift8 = np.frombuffer(_shift8_matrix(), dtype=np.uint32)
    tabs = [_crc_byte_table()]
    for _ in range(15):
        tabs.append(_apply_cols(shift8, tabs[-1]))
    return np.stack(tabs)


@functools.cache
def crc_lane_tables() -> np.ndarray:
    """(32, 4, 256) uint32: lane l's byte tables of the shift over
    16 (31 - l) bytes, which places the lane's 16 bytes in a 512-byte row."""
    return np.stack([_byte_tables(_shift_cols(16 * (31 - lane)))
                     for lane in range(32)])


@functools.cache
def crc_shift_tables(levels: int) -> np.ndarray:
    """(levels, 4, 256) uint32: level b's byte tables of the shift over 2^b
    bytes."""
    return np.stack([_byte_tables(np.frombuffer(_shift_matrix_pow(b),
                                                dtype=np.uint32))
                     for b in range(levels)])


# ---------------------------------------------------------------------------
# Device checksums
# ---------------------------------------------------------------------------


def adler32_tensor(data, device=None) -> torch.Tensor:
    """Adler-32 on the card as a (1,) int64 tensor on the payload's device,
    with no host sync (bytes or a 1-D uint8 tensor; a tensor runs on its own
    device, bytes go to `device`, None meaning CUDA)."""
    from . import checksum_kernels as ck

    x = as_u8_tensor(data, device)
    n = x.shape[0]
    if n == 0:
        return torch.ones(1, dtype=torch.int64, device=x.device)
    nchunks = -(-n // ck.CHUNK)
    padded = torch.zeros(nchunks * ck.CHUNK, dtype=torch.uint8, device=x.device)
    padded[:n] = x
    s_c, w_c = ck.adler_chunks(padded.view(nchunks, ck.CHUNK))
    return ck.combine_chunks(s_c, w_c, n, nchunks * ck.CHUNK)


def crc32_raw_tensor(data, device=None) -> torch.Tensor:
    """The raw CRC (init 0, no final inversion) on the card as K3's (1,)
    int32 bit pattern on the payload's device, with no host sync (bytes or
    a 1-D uint8 tensor, placed as for adler32_tensor).

    The payload is read in place when it is contiguous and 16-byte aligned,
    else from one aligned copy: K2 takes its full rows and its tail (one
    front-padded row) and K3 folds them."""
    from . import checksum_kernels as ck

    x = as_u8_tensor(data, device)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(1, dtype=torch.int32, device=x.device)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    row = ck.CRC_ROW_BYTES
    full = n // row
    rows, tail = x[:full * row].view(full, row), x[full * row:]
    return ck.crc_combine(ck.crc_rows(rows, tail), n - full * row or row)


def upload_packed(payloads, device) -> tuple[list, list]:
    """Each payload (bytes-like) as a 1-D uint8 tensor on `device`, all from
    one upload with no host sync. The payloads lie at 16-byte aligned
    offsets of one host buffer, so that K2 reads each in place; for a card
    the buffer is pinned and returned in keep, to hold until the caller
    next synchronizes. Returns (tensors, keep)."""
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
    buf = host.to(dev, non_blocking=True)
    return [buf[off:off + len(p)] for off, p in zip(offs, payloads)], (
        [host] if cuda else [])


def crc32_many(payloads, device=None) -> list[int]:
    """The crc32 of each payload (bytes-like) on `device` (None: the CUDA
    card): the non-empty ones from one upload (upload_packed), K2 + K3 a
    payload with no host sync between them, and one fetch of every raw CRC.
    An empty payload's crc32 is 0, with no device work."""
    sizes = [len(p) for p in payloads]
    views, keep = upload_packed([p for p in payloads if len(p)], device)
    raws = iter(torch.cat([crc32_raw_tensor(v) for v in views]).tolist()
                if views else [])
    del keep
    return [crc32_finish(next(raws), n) if n else 0 for n in sizes]


def _crc_mix(nbytes: int) -> int:
    """What turns the raw CRC of n bytes into their crc32: the initial
    register shifted over n bytes, with the final inversion. It depends
    only on n, so it stays on the host."""
    return crc_shift_register(0xFFFFFFFF, nbytes) ^ 0xFFFFFFFF


def crc32_finish(raw: int, nbytes: int) -> int:
    """crc32 of n bytes from their raw CRC (a fetched crc32_raw_tensor)."""
    return (raw & 0xFFFFFFFF) ^ _crc_mix(nbytes)


def crc32_tensor(data, device=None) -> torch.Tensor:
    """CRC-32 on the card as a (1,) int64 tensor on the payload's device,
    with no host sync (bytes or a 1-D uint8 tensor, placed as for
    adler32_tensor): crc32_raw_tensor with the host constant of
    crc32_finish XORed in on the card."""
    x = as_u8_tensor(data, device)
    raw = crc32_raw_tensor(x)
    mix = _crc_mix(x.shape[0])
    mix -= (mix >> 31) << 32                    # as an int32 bit pattern
    return (raw ^ mix).view(torch.uint32).to(torch.int64)


def adler32_device(data, device=None) -> int:
    """Adler-32 on the card (bytes or a 1-D uint8 tensor), fetched."""
    with profiling.span("checksums"):
        adler = adler32_tensor(data, device)
    with profiling.span("checksum.wait"):
        return int(adler)


def crc32_device(data, device=None) -> int:
    """CRC-32 on the card (bytes or a 1-D uint8 tensor): K3's raw CRC
    fetched (4 bytes) and finished on the host."""
    x = as_u8_tensor(data, device)
    with profiling.span("checksums"):
        raw = crc32_raw_tensor(x)
    with profiling.span("checksum.wait"):
        raw = int(raw)
    return crc32_finish(raw, x.shape[0])
