"""The decode's token extraction and block table kernels (csrc/inflate.cu)
and their plain PyTorch versions.

K4 `inflate_extract` replaces the jnp/XLA `_extract` of
zippy_tpu/ops/inflate_device.py (with `_cmp_decode` and `_rev15`) for a
batch of tiles at once: every busy segment lane of every tile decodes up to
k sequential DEFLATE tokens from its bit offset with its block's comparison
tables, and the tokens come back packed exactly as the reference packs
them, (k, total busy lanes) int32, tile after tile: `out_len << 16 |
literal`, `out_len << 16 | (dist + 256)`, or 0 for slots past the lane's
token count. A tile's busy lanes are the first `used` of its segment table;
the reference's padding lanes past them hold only zeros.

Tables are one (nblk, 382) int32 row per Huffman block (TABLE_WORDS): the
litlen code's fc (16), off (16), E (288), then the distance code's fc (16),
off (16), E (30), as `_cmp_tables` builds them. A lane reads its own
block's row: the TPU version's one-hot matmul that copied the rows to every
lane is not needed. The kernel stages the rows its lanes use
in shared memory with a first-level table of 2^FAST_BITS entries per code
(`_fast_table_plain` is its plain version, for the tests).

K9 `block_tables` builds those rows, a batch's at once, from the scan's
code-length records: it replaces the reference's `_cmp_tables` (:176) as
`_build_lane_tables` (:229) applies it, one CTA a row, one symbol a lane
(csrc/inflate.cu says how). Its plain version is `block_tables_plain`,
about 80 torch ops a batch.

Each wrapper launches its kernel on CUDA tensors (or raises) and runs the
plain version on CPU tensors. The kernels build with nvcc at first CUDA use
(ops/kernel_build.py); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
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
# csrc/inflate.cu's kThreads (busy lanes per CTA) and kFastBits.
LANES_PER_CTA = 128
FAST_BITS = 9

_M32 = 0xFFFFFFFF


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("inflate.cu")))
    except OSError as e:
        raise ZippyError(f"cannot load the inflate kernel: {e}") from e
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zt_inflate_extract.argtypes = [p, i64, i32, p, i64, i64, p, i32, i32,
                                       p, i32, i32, i32, p, p, p, i32]
    lib.zt_inflate_extract.restype = i32
    lib.zt_block_tables.argtypes = [p, i64, i64, i32, i32, p, p, p, p, i32]
    lib.zt_block_tables.restype = i32
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
    fc/off (nlanes, 16) the lanes' boundary and offset rows, and each lane's
    rank -> entry row of n entries at flat[e_at:]. Returns (entry, code
    length): the length is 1 + the number of exceeded boundaries, the entry
    that of rank code + off[len], 0 for a rank outside the row."""
    lens = torch.arange(1, 15, device=r.device)
    cl = 1 + ((r[:, None] >> (15 - lens)) >= fc[:, 1:15]).sum(dim=1)
    rank = (r >> (15 - cl)) + off.gather(1, cl[:, None])[:, 0]
    inside = (rank >= 0) & (rank < n)
    return torch.where(inside, flat[e_at + rank.clamp(0, n - 1)], 0), cl


def _fast_table_plain(tables: torch.Tensor) -> torch.Tensor:
    """Plain version of K4's first-level tables, in the kernel's layout:
    (nrows, 2, 2^FAST_BITS) int32, the litlen code's then the distance
    code's, from tables (nrows, 382). Entry p is the comparison decode's
    entry for the 15-bit windows whose first FAST_BITS code bits are p,
    where the boundaries of lengths 1..FAST_BITS give a length cl <=
    FAST_BITS; else 0, and the kernel takes the compares. With tables as
    `_cmp_tables` builds them (fc[j + 1] >= 2 fc[j]) the other bits cannot
    change such an entry, which is that of a symbol of length cl (E =
    symbol | length, never 0)."""
    t = tables.to(torch.int64)
    dev = t.device
    p = torch.arange(1 << FAST_BITS, device=dev)
    lens = torch.arange(1, FAST_BITS + 1, device=dev)
    out = []
    for at, n in ((FC_L, LL_SYMS), (FC_D, D_SYMS)):
        cl = 1 + ((p[:, None] >> (FAST_BITS - lens)) >= t[
            :, None, at + 1:at + FAST_BITS + 1]).sum(-1)   # (nrows, 2^bits)
        short = cl <= FAST_BITS
        cl = cl.clamp(max=FAST_BITS)
        rank = (p >> (FAST_BITS - cl)) + t[:, at + OFF_L:].gather(1, cl)
        e = torch.where((rank >= 0) & (rank < n), t[:, at + E_L:].gather(
            1, rank.clamp(0, n - 1)), 0)
        out.append(torch.where(short, e, 0))
    return torch.stack(out, dim=1).to(torch.int32)


def _busy_lanes(used, device):
    """(tile, lane) of every busy lane, tile after tile."""
    counts = torch.tensor(used, dtype=torch.int64)
    tile = torch.repeat_interleave(torch.arange(len(used)), counts)
    lane = torch.arange(tile.numel()) - (torch.cumsum(counts, 0)
                                         - counts)[tile]
    return tile.to(device), lane.to(device)


def _extract_plain(words, seg, used, tables, k: int) -> torch.Tensor:
    """Plain version of K4, step for step (int64 on the host: 32-bit words
    masked, logical shifts): each busy lane reads its own tile's words and
    block rows."""
    ntiles, nw = words.shape
    nblk = tables.shape[0] // ntiles
    tile, lane = _busy_lanes(used, words.device)
    w = words.to(torch.int64).reshape(-1) & _M32
    t64 = tables.to(torch.int64)
    flat = t64.reshape(-1)
    blk = seg[tile, 1, lane].to(torch.int64).clamp(0, nblk - 1) + tile * nblk
    rows = t64[:, :E_L][blk]                              # (nlanes, 32)
    fc_l, off_l = rows[:, FC_L:OFF_L], rows[:, OFF_L:E_L]
    rows = t64[:, FC_D:E_D][blk]
    fc_d, off_d = rows[:, :16], rows[:, 16:]
    e_l, e_d = blk * TABLE_WORDS + E_L, blk * TABLE_WORDS + E_D
    wbase = tile * nw
    bit = seg[tile, 0, lane].to(torch.int64)
    ntok = seg[tile, 2, lane].to(torch.int64)
    packed = torch.zeros(k, bit.shape[0], dtype=torch.int32,
                         device=words.device)
    for i in range(k):
        active = i < ntok
        iw = (bit >> 5).clamp(0, nw - 1)
        w0 = w[wbase + iw]
        w1 = w[wbase + (iw + 1).clamp(max=nw - 1)]
        w2 = w[wbase + (iw + 2).clamp(max=nw - 1)]
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
    """int32 of `dim` dimensions whose last one is contiguous (rows may lie
    apart, as views into the tiles' packed buffers do)."""
    if x.dtype != torch.int32 or x.dim() != dim or x.stride(-1) != 1 \
            or min(x.stride()) < 0:
        raise ZippyError(f"{name} must be a {dim}-D int32 tensor with "
                         f"contiguous rows, got {tuple(x.shape)} {x.dtype} "
                         f"strides {x.stride()}")


def inflate_extract(words, seg, used, tables, k: int,
                    off_run=None) -> torch.Tensor:
    """Decode up to k tokens per busy segment lane of a batch of tiles:
    words (ntiles, nwords) int32 bit patterns of each tile's stream; seg
    (ntiles, 3, nseg) int32, each tile's rows of bit offset into its words,
    block row and token count; used, the busy lanes of each tile (host
    ints, at most nseg each: its first `used` lanes); tables
    (ntiles * nblk, 382) int32, tile t's blocks at rows t * nblk on. Rows
    may be views into the tiles' packed buffers. Returns packed
    (k, sum(used)) int32, tile t's lanes in the columns from
    sum(used[:t]) on. K4 on CUDA tensors (one launch; none when no lane is
    busy), the plain version on CPU tensors. `off_run`, a (1,) int64 CUDA
    tensor, has K4 add the lanes whose block row it did not stage."""
    _check(words, "words", 2)
    _check(seg, "seg", 3)
    _check(tables, "tables", 2)
    ntiles, nwords = words.shape
    nrows = tables.shape[0]
    if not tables.is_contiguous() or tables.shape[1] != TABLE_WORDS \
            or not ntiles or not nwords or not nrows or nrows % ntiles:
        raise ZippyError(f"expected words (ntiles >= 1, nwords >= 1) and "
                         f"contiguous (ntiles * nblk >= 1, {TABLE_WORDS}) "
                         f"tables, got {tuple(words.shape)} and "
                         f"{tuple(tables.shape)}")
    if seg.shape[:2] != (ntiles, 3):
        raise ZippyError(f"seg must be ({ntiles}, 3, nseg), got "
                         f"{tuple(seg.shape)}")
    nseg = seg.shape[2]
    used = [int(u) for u in used]
    if len(used) != ntiles or not all(0 <= u <= nseg for u in used):
        raise ZippyError(f"expected {ntiles} busy-lane counts in 0..{nseg}, "
                         f"got {used}")
    if not 1 <= k <= 1024:
        raise ZippyError(f"k {k} is not in 1..1024")
    if len({x.device for x in (words, seg, tables)}) != 1:
        raise ZippyError("the inputs lie on different devices")
    dev = words.device
    if dev.type == "cpu":
        return _extract_plain(words, seg, used, tables, k)
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    if off_run is not None and (off_run.dtype != torch.int64
                                or off_run.shape != (1,)
                                or off_run.device != dev):
        raise ZippyError("off_run must be a (1,) int64 tensor on the card")
    out = torch.empty(k, sum(used), dtype=torch.int32, device=dev)
    if out.shape[1]:
        bases, ncta = _bases(used, dev)
        _launch(words, seg, bases, ncta, tables, k, out, off_run)
    return out


def _bases(used: list[int], device: torch.device):
    """The batch's busy-lane prefix sums, then its CTA prefix sums
    (LANES_PER_CTA lanes a CTA), as one (2 * (ntiles + 1),) int32 tensor on
    `device`, uploaded from pinned memory without a host sync; and the
    number of CTAs."""
    lanes, ctas = [0], [0]
    for u in used:
        lanes.append(lanes[-1] + u)
        ctas.append(ctas[-1] + -(-u // LANES_PER_CTA))
    host = torch.tensor(lanes + ctas, dtype=torch.int32).pin_memory()
    return host.to(device, non_blocking=True), ctas[-1]


def _launch(words, seg, bases, ncta: int, tables, k: int, out,
            off_run=None) -> None:
    """One K4 launch over checked CUDA tensors into out (k, total busy
    lanes); `bases` and `ncta` as `_bases` gives them."""
    dev = words.device
    ntiles = words.shape[0]
    rc = _lib().zt_inflate_extract(
        words.data_ptr(), words.stride(0), words.shape[1], seg.data_ptr(),
        seg.stride(0), seg.stride(1), bases.data_ptr(), ntiles, ncta,
        tables.data_ptr(), tables.shape[0] // ntiles, k, out.shape[1],
        out.data_ptr(), None if off_run is None else off_run.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    kernel_build.check_launch(rc, "inflate_extract")
    LAUNCHES["inflate_extract"] += 1


# RFC 1951's length and distance bases and extra bits, for the entries.
_LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
     67, 83, 99, 115, 131, 163, 195, 227, 258], dtype=np.int64)
_LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
     5, 5, 5, 5, 0], dtype=np.int64)
_DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
     513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
     24577], dtype=np.int64)
_DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
     10, 11, 11, 12, 12, 13, 13], dtype=np.int64)

# Per-symbol packed litlen entries, without the code length (added from the
# block's lengths): bit5 literal flag, bits8-15 literal byte, bits16-24
# length base, bits25-27 length extra count.
_LL_ENT = np.zeros(LL_SYMS, dtype=np.int64)
_LL_ENT[:256] = (1 << 5) | (np.arange(256, dtype=np.int64) << 8)
_LL_ENT[257:286] = (_LENGTH_BASE << 16) | (_LENGTH_EXTRA << 25)
# Dist entries: bits5-8 extra count, bits16-30 base - 1.
_D_ENT = (_DIST_EXTRA << 5) | ((_DIST_BASE - 1) << 16)


@functools.cache
def _entries(device: torch.device):
    """(_LL_ENT, _D_ENT) as int64 tensors on `device`, uploaded once; a
    CUDA upload goes from pinned memory, without a host sync."""
    out = []
    for arr in (_LL_ENT, _D_ENT):
        t = torch.from_numpy(arr)
        if device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return tuple(out)


# The scan's code-length record of a block: 288 litlen, then 30 distance.
LENS_PER_ROW = LL_SYMS + D_SYMS


def _cmp_tables(lens: torch.Tensor, ent: torch.Tensor):
    """Per-block comparison-decode tables from code lengths (nblk, S):
    fc (nblk, 16) = first_code + count per length (the Moffat range
    boundaries), off (nblk, 16) = rank_base - first_code, and E (nblk, S) =
    packed entry (ent | len) of the symbol at each canonical rank. int32."""
    nblk, S = lens.shape
    dev = lens.device
    lens = lens.to(torch.int64).clamp(0, 15)
    oh = (lens[:, :, None] == torch.arange(16, device=dev)).to(torch.int64)
    count = oh.sum(dim=1)                                  # (nblk, 16)
    # first[b] = sum over 1 <= j < b of count[j] << (b - j): the canonical
    # recurrence first[b] = (first[b-1] + count[b-1]) << 1 from first[1] = 0.
    b = torch.arange(16, device=dev)
    shift = b[None, :] - b[:, None]                        # [j, b] = b - j
    weight = torch.where((shift > 0) & (b[:, None] >= 1),
                         1 << shift.clamp(min=0), 0)
    first = (count[:, :, None] * weight[None]).sum(dim=1)
    fc = first + count
    cnt_a = torch.cat([torch.zeros_like(count[:, :1]), count[:, 1:]], dim=1)
    sym_base = torch.cumsum(cnt_a, dim=1) - cnt_a          # shorter codes
    off = sym_base - first
    # Canonical rank of each symbol: sym_base[len] + rank within its length.
    rank_in = torch.cumsum(oh, dim=1) - oh
    rank_sym = (sym_base.gather(1, lens)
                + rank_in.gather(2, lens[:, :, None])[:, :, 0])
    # Absent symbols (and any rank out of the row) go to one spare column.
    pos = torch.where((lens > 0) & (rank_sym < S), rank_sym, S)
    E = torch.zeros(nblk, S + 1, dtype=torch.int64, device=dev).scatter_(
        1, pos, ent[None, :] | lens)[:, :S]
    return fc.to(torch.int32), off.to(torch.int32), E.to(torch.int32)


def block_tables_plain(lens8: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: `_cmp_tables` of the litlen half and of the
    distance half of (nblk, 318) uint8 records, (nblk, 382) int32."""
    ll_ent, d_ent = _entries(lens8.device)
    fc_l, off_l, e_l = _cmp_tables(lens8[:, :LL_SYMS], ll_ent)
    fc_d, off_d, e_d = _cmp_tables(lens8[:, LL_SYMS:LENS_PER_ROW], d_ent)
    return torch.cat([fc_l, off_l, e_l, fc_d, off_d, e_d], dim=1)


def block_tables(lens8: torch.Tensor) -> torch.Tensor:
    """K4's tables from the scan's code-length records: lens8 uint8, 2-D
    (rows, 318) or 3-D (ntiles, nblk, 318), records contiguous, rows and
    tiles at any non-negative strides (views into the tiles' packed
    buffers). Returns (rows, 382) int32, row r the litlen code's fc, off,
    E, then the distance code's (TABLE_WORDS); a 3-D input's rows tile
    after tile. K9 on CUDA tensors (one launch), the plain version
    (block_tables_plain) on CPU tensors."""
    if lens8.dtype != torch.uint8 or lens8.dim() not in (2, 3) \
            or lens8.shape[-1] != LENS_PER_ROW or lens8.stride(-1) != 1 \
            or min(lens8.stride()) < 0:
        raise ZippyError(f"lens8 must be a 2-D or 3-D uint8 tensor of "
                         f"{LENS_PER_ROW}-byte contiguous records, got "
                         f"{tuple(lens8.shape)} {lens8.dtype} strides "
                         f"{lens8.stride()}")
    view = lens8 if lens8.dim() == 3 else lens8[None]
    ntiles, nblk, _ = view.shape
    rows = ntiles * nblk
    dev = lens8.device
    if dev.type == "cpu":
        return block_tables_plain(view.reshape(rows, LENS_PER_ROW))
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    ll_ent, d_ent = _entries(dev)
    out = torch.empty(rows, TABLE_WORDS, dtype=torch.int32, device=dev)
    if rows:
        rc = _lib().zt_block_tables(
            view.data_ptr(), view.stride(0), view.stride(1), nblk, rows,
            ll_ent.data_ptr(), d_ent.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
        kernel_build.check_launch(rc, "block_tables")
        LAUNCHES["block_tables"] += 1
    return out
