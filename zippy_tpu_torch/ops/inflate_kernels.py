"""The decode's token extraction kernel (csrc/inflate.cu) and its plain
PyTorch version.

K4 `inflate_extract` replaces the jnp/XLA `_extract` of
zippy_tpu/ops/inflate_device.py (with `_cmp_decode` and `_rev15`): every
segment lane of a tile decodes up to k sequential DEFLATE tokens from its
bit offset with its block's comparison tables, and the tokens come back
packed exactly as the reference packs them, (k, nseg) int32:
`out_len << 16 | literal`, `out_len << 16 | (dist + 256)`, or 0 for slots
past the lane's token count.

Tables are one (nblk, 382) int32 row per Huffman block (TABLE_WORDS): the
litlen code's fc (16), off (16), E (288), then the distance code's fc (16),
off (16), E (30), as ops/inflate_device._cmp_tables builds them. A lane
reads its own block's row: the TPU version's one-hot matmul that copied the
rows to every lane is not needed.

The wrapper launches K4 on CUDA tensors (or raises) and runs the plain
version on CPU tensors. The kernel builds with nvcc at first CUDA use
(ops/kernel_build.py); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..common import ZippyError
from . import kernel_build
from .kernel_build import LAUNCHES

LL_SYMS, D_SYMS = 288, 30
# Offsets inside one block's table row; csrc/inflate.cu has the same layout.
FC_L, OFF_L, E_L = 0, 16, 32
FC_D = E_L + LL_SYMS
OFF_D, E_D = FC_D + 16, FC_D + 32
TABLE_WORDS = E_D + D_SYMS          # 382

_M32 = 0xFFFFFFFF


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("inflate.cu")))
    except OSError as e:
        raise ZippyError(f"cannot load the inflate kernel: {e}") from e
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.zt_inflate_extract.argtypes = [p, i32, p, p, p, i32, p, i32, i32, p,
                                       p, i32]
    lib.zt_inflate_extract.restype = i32
    return lib


def _rev15(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 15 bits (of a non-negative value < 2^16)."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def _cmp_decode(r, fc, off, flat, e_at, n: int):
    """One comparison decode across lanes: r the bit-reversed 15-bit window,
    fc/off (nseg, 16) the lanes' boundary and offset rows, and each lane's
    rank -> entry row of n entries at flat[e_at:]. Returns (entry, code
    length): the length is 1 + the number of exceeded boundaries, the entry
    that of rank code + off[len], 0 for a rank outside the row."""
    lens = torch.arange(1, 15, device=r.device)
    cl = 1 + ((r[:, None] >> (15 - lens)) >= fc[:, 1:15]).sum(dim=1)
    rank = (r >> (15 - cl)) + off.gather(1, cl[:, None])[:, 0]
    inside = (rank >= 0) & (rank < n)
    return torch.where(inside, flat[e_at + rank.clamp(0, n - 1)], 0), cl


def _extract_plain(words, seg_bit, seg_blk, seg_ntok, tables,
                   k: int) -> torch.Tensor:
    """Plain version of K4, step for step (int64 on the host: 32-bit words
    masked, logical shifts)."""
    nw, nblk = words.shape[0], tables.shape[0]
    w = words.to(torch.int64) & _M32
    flat = tables.to(torch.int64).reshape(-1)
    blk = seg_blk.to(torch.int64).clamp(0, nblk - 1)
    rows = tables.to(torch.int64)[:, :E_L][blk]           # (nseg, 32)
    fc_l, off_l = rows[:, FC_L:OFF_L], rows[:, OFF_L:E_L]
    rows = tables.to(torch.int64)[:, FC_D:E_D][blk]
    fc_d, off_d = rows[:, :16], rows[:, 16:]
    e_l, e_d = blk * TABLE_WORDS + E_L, blk * TABLE_WORDS + E_D
    bit = seg_bit.to(torch.int64)
    ntok = seg_ntok.to(torch.int64)
    packed = torch.zeros(k, bit.shape[0], dtype=torch.int32,
                         device=words.device)
    for i in range(k):
        active = i < ntok
        iw = (bit >> 5).clamp(0, nw - 1)
        w0 = w[iw]
        w1 = w[(iw + 1).clamp(max=nw - 1)]
        w2 = w[(iw + 2).clamp(max=nw - 1)]
        sh = bit & 31
        lo = (w0 >> sh) | ((w1 << (32 - sh)) & _M32)
        hi = (w1 >> sh) | ((w2 << (32 - sh)) & _M32)
        e, cl = _cmp_decode(_rev15(lo & 0x7FFF), fc_l, off_l, flat, e_l,
                            LL_SYMS)
        is_lit = ((e >> 5) & 1) == 1
        lb = (e >> 8) & 0xFF
        lbase = (e >> 16) & 0x1FF
        lx = (e >> 25) & 7
        length = lbase + ((lo >> cl) & ((1 << lx) - 1))
        sh2 = cl + lx
        lo2 = (lo >> sh2) | ((hi << (32 - sh2)) & _M32)
        de, dcl = _cmp_decode(_rev15(lo2 & 0x7FFF), fc_d, off_d, flat, e_d,
                              D_SYMS)
        dx = (de >> 5) & 15
        dist = ((de >> 16) & 0x7FFF) + 1 + ((lo2 >> dcl) & ((1 << dx) - 1))
        val = torch.where(is_lit, (1 << 16) | lb,
                          (length << 16) | (dist + 256))
        packed[i] = torch.where(active, val, 0).to(torch.int32)
        bit = torch.where(active, torch.where(is_lit, bit + cl,
                                              bit + sh2 + dcl + dx), bit)
    return packed


def _check(x: torch.Tensor, name: str, dim: int) -> None:
    if x.dtype != torch.int32 or x.dim() != dim or not x.is_contiguous():
        raise ZippyError(f"{name} must be a contiguous {dim}-D int32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")


def inflate_extract(words, seg_bit, seg_blk, seg_ntok, tables,
                    k: int) -> torch.Tensor:
    """Decode up to k tokens per segment lane: words (nwords,) int32 bit
    patterns of the tile's stream; seg_bit, seg_blk, seg_ntok (nseg,) int32
    (bit offset into words, table row, token count); tables (nblk, 382)
    int32. Returns packed (k, nseg) int32. K4 on CUDA tensors, the plain
    version on CPU tensors."""
    for x, name, dim in ((words, "words", 1), (seg_bit, "seg_bit", 1),
                         (seg_blk, "seg_blk", 1), (seg_ntok, "seg_ntok", 1),
                         (tables, "tables", 2)):
        _check(x, name, dim)
    nseg = seg_bit.shape[0]
    if seg_blk.shape[0] != nseg or seg_ntok.shape[0] != nseg:
        raise ZippyError("the segment arrays differ in length")
    if not words.numel() or tables.shape[0] < 1 \
            or tables.shape[1] != TABLE_WORDS:
        raise ZippyError(f"expected words and (nblk >= 1, {TABLE_WORDS}) "
                         f"tables, got {tuple(words.shape)} and "
                         f"{tuple(tables.shape)}")
    if not 1 <= k <= 1024:
        raise ZippyError(f"k {k} is not in 1..1024")
    if len({x.device for x in (words, seg_bit, seg_blk, seg_ntok,
                               tables)}) != 1:
        raise ZippyError("the inputs lie on different devices")
    dev = words.device
    if dev.type == "cpu":
        return _extract_plain(words, seg_bit, seg_blk, seg_ntok, tables, k)
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    out = torch.empty(k, nseg, dtype=torch.int32, device=dev)
    rc = _lib().zt_inflate_extract(
        words.data_ptr(), words.numel(), seg_bit.data_ptr(),
        seg_blk.data_ptr(), seg_ntok.data_ptr(), nseg, tables.data_ptr(),
        tables.shape[0], k, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    kernel_build.check_launch(rc, "inflate_extract")
    LAUNCHES["inflate_extract"] += 1
    return out
