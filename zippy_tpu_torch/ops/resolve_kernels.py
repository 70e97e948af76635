"""The decode's LZ resolution kernel (csrc/resolve.cu) and its plain
PyTorch version.

K6 `lz_resolve` replaces the jnp/XLA `_resolve` of
zippy_tpu/ops/inflate_device.py (:359, with `_ffill_span` :340): the
output bytes of one tile from its extracted tokens, its stored spans and
the 32 KiB halo of decoded bytes before it. Positions [0, HALO) of the
output are the halo; the tile's bytes are [HALO, HALO + used), and
out[used:used + HALO] is the next tile's halo. A literal token is its
byte, a stored span a copy of its bytes from the tile's stream words, and
byte o of a match token at `start` with distance d reads the byte at
start - d + (o mod d); a chain of such reads across tokens ends at a
literal, a stored byte or the halo.

The plain version, `_resolve_plain`, computes it with torch ops: one token
scatter, a forward fill (`_ffill`), a copy per stored span, match-byte
compaction and `nrounds` rounds of pointer doubling over the compacted
match bytes, then a value gather and a scatter back. K6 computes the same
bytes (csrc/resolve.cu says how) in 1 + ceil(max(nrounds, 1) / b)
launches (`launches_per_tile`): an expansion of the tokens and stored spans into one
int32 state a byte, then rounds over the tile's bytes that each take
2^b - 1 hops a byte and so reach as far as b of the plain version's
doubling rounds (b = 3 for a tile of up to SMALL_TILE bytes, every CFG_S
tile; 2 for a larger one).
Every byte a caller reads, out[:HALO + used], equals the plain version's.
Past HALO + used the output is padding, which the plain version fills with
the last token's payload and K6 leaves unwritten.

The wrapper launches K6 on CUDA tensors (or raises) and runs the plain
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

HALO = 32768        # DEFLATE window: matches never reach further back
STO_MAX = 1 << 16   # a stored span's LEN field is 16-bit
# K6's rounds (csrc/resolve.cu's kSmallTile, kSmallHops, kLargeHops): the
# hops a byte a round for a tile of up to SMALL_TILE bytes and for a larger
# one.
SMALL_TILE = 1 << 18
SMALL_HOPS, LARGE_HOPS = 7, 3


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("resolve.cu")))
    except OSError as e:
        raise ZippyError(f"cannot load the resolve kernel: {e}") from e
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zt_lz_resolve.argtypes = [p, i64, i32, i32, p, p, i32, p, i32, p,
                                  i32, i32, i32, p, p, p, i32,
                                  ctypes.POINTER(i32)]
    lib.zt_lz_resolve.restype = i32
    return lib


def hops_per_round(used: int) -> int:
    """The hops K6's rounds take a byte on a tile of `used` bytes."""
    return SMALL_HOPS if used <= SMALL_TILE else LARGE_HOPS


def rounds_for(nrounds: int, hops: int) -> int:
    """Rounds of `hops` hops that reach as far down every chain as nrounds
    doubling rounds: h hops multiply a byte's reach by h + 1, so that
    2^b - 1 hops make b doubling rounds of each (csrc/resolve.cu's
    rounds_for)."""
    b = 3 if hops >= 7 else 2 if hops >= 3 else 1
    return -(-nrounds // b) if nrounds > 0 else 1


def launches_per_tile(nrounds: int, used: int) -> int:
    """K6's kernel launches for one tile of `used` bytes: the expansion,
    then the rounds, the last of which also writes the bytes still open."""
    return 1 + rounds_for(nrounds, hops_per_round(used))


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _ffill(flag: torch.Tensor, *arrays: torch.Tensor):
    """Forward-fill: position i takes each array's value at the last p <= i
    where flag is set (0 before the first). Returns (p or 0, filled...).
    One scan: the running count of set positions numbers them; each set
    position scatters itself to its number, and every position gathers the
    position of its count. No fill distance bound (the reference's 9
    shifted selects reach 511 positions). torch.cummax over the positions
    computes the same, but measured 9.3 ms a call on a 4 MiB tile on the
    H100."""
    n = flag.shape[0]
    rank = torch.cumsum(flag, dim=0) - 1
    has = rank >= 0
    pos = torch.arange(n, device=flag.device)
    first = _scatter(n, torch.where(flag, rank, n), pos)
    at = first[rank.clamp(min=0)]
    return (torch.where(has, at, 0),
            *(torch.where(has, a[at], 0) for a in arrays))


def _scatter(size: int, index: torch.Tensor, values: torch.Tensor,
             base=None) -> torch.Tensor:
    """values written at `index` into a buffer of `size` (zeros, or a copy
    of `base`); indices outside [0, size) go to one spare trailing slot,
    which is cut off."""
    index = torch.where((index >= 0) & (index < size), index, size)
    buf = torch.zeros(size + 1, dtype=values.dtype, device=values.device)
    if base is not None:
        buf[:size] = base
    return buf.scatter_(0, index, values)[:size]


def _resolve_plain(packed, seg_out, words, stored, halo, nrounds: int,
                   cfg) -> torch.Tensor:
    """Output bytes from the extracted tokens and the stored spans.

    Positions [0, HALO) are the carried window (literal fixpoints valued from
    `halo`); the tile's output occupies [HALO, HALO + tile_out). `stored`
    lists the tile's stored spans as host ints (source byte in the words,
    output position, length). One token scatter places a packed (dist, lit)
    payload at each token's first byte, a forward fill spreads it over the
    span; literals finish there. Match bytes compact into cfg.ncmp slots,
    take the closed-form overlap source start - dist + (o mod dist), and
    resolve by `nrounds` pointer-doubling hops over the compact slots."""
    out_pad = HALO + cfg.tile_out
    C = cfg.ncmp
    dev = packed.device
    tok = packed.T.to(torch.int64)                         # (nseg, k)
    out_len = tok >> 16
    low = tok & 0xFFFF
    is_mt = low >= 256
    dists = torch.where(is_mt, low - 256, 0)
    litbyte = torch.where(is_mt, 0, low)

    # Token output starts: per-segment base from the index plus the prefix
    # sum of the lane's token lengths.
    starts = seg_out.to(torch.int64)[:, None] + (
        torch.cumsum(out_len, dim=1) - out_len)
    valid = out_len > 0
    flat_starts = torch.where(valid, starts, out_pad).reshape(-1)
    flat_dist = dists.reshape(-1)
    flat_lit = litbyte.reshape(-1)
    flat_mlen = torch.where(is_mt & valid, out_len, 0).reshape(-1)

    j = torch.arange(out_pad, device=dev)
    payload = (flat_dist << 9) | (flat_lit << 1) | 1
    pay_at = _scatter(out_pad, flat_starts, payload)
    _, pay = _ffill(pay_at != 0, pay_at)
    dist_span = pay >> 9
    lit_base = torch.cat([halo.to(torch.int64), (pay[HALO:] >> 1) & 0xFF])

    # Stored spans: one contiguous copy each, from the tile's words.
    in_sto = torch.zeros(out_pad, dtype=torch.bool, device=dev)
    src_bytes = words.view(torch.uint8)
    nbytes = src_bytes.shape[0]
    for src, o0, ln in stored:
        src = min(max(src, 0), nbytes)
        o0 = min(max(o0, 0), out_pad)
        ln = max(0, min(ln, STO_MAX, out_pad - o0))
        n = min(ln, nbytes - src)
        lit_base[o0:o0 + n] = src_bytes[src:src + n]
        lit_base[o0 + n:o0 + ln] = 0
        in_sto[o0:o0 + ln] = True

    # Match-byte compaction: byte i of match token t sits at compact slot
    # cb[t] + i (tokens partition the output in order). The fill past the
    # tile's last token marks padding bytes too; they sort after every real
    # match byte and are masked by total_m below.
    is_m = (dist_span > 0) & ~in_sto & (j >= HALO)
    cidx = torch.cumsum(is_m, dim=0) - 1
    pfull = torch.where(is_m, cidx, -(j + 1))

    cb = torch.cumsum(flat_mlen, dim=0) - flat_mlen
    total_m = flat_mlen.sum()
    cpos = torch.where(flat_mlen > 0, cb, C)
    fs_at = _scatter(C, cpos, flat_starts)
    d_at = _scatter(C, cpos, flat_dist)
    cb_f, fs_f, d_f = _ffill(fs_at != 0, fs_at, d_at)

    # Overlapping copies (dist < len) in closed form: byte o of a span reads
    # span_start - d + (o mod d). Real targets are strictly earlier bytes,
    # so chains strictly decrease and end at literals, halo or stored bytes.
    ii = torch.arange(C, device=dev)
    o = ii - cb_f
    f_i = fs_f + o
    t = (fs_f - d_f + o % d_f.clamp(min=1)).clamp(0, out_pad - 1)
    p = pfull[t]
    # p < 0 is a resolved literal source -(pos + 1); p >= 0 the compact slot
    # of the next hop.
    for _ in range(nrounds):
        p = torch.where(p < 0, p, p[p.clamp(0, C - 1)])
    vals = lit_base[(-p - 1).clamp(0, out_pad - 1)]
    fpos = torch.where((ii < total_m) & (fs_f > 0),
                       f_i.clamp(0, out_pad), out_pad)
    return _scatter(out_pad, fpos, vals, base=lit_base).to(torch.uint8)


def stored_spans(sto: torch.Tensor) -> list:
    """A tile's stored-span table (3, nsto), rows source byte, output
    position and length, as the plain version's host ints; the table's
    empty slots (length 0) are left out."""
    return [tuple(s) for s in sto.T.tolist() if s[2] > 0]


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, name: str, dim: int, dtype=torch.int32) -> None:
    """`dtype` of `dim` dimensions whose last one is contiguous (rows may
    lie apart, as views into the tiles' packed buffers do); an empty
    tensor's strides are not read."""
    if x.dtype != dtype or x.dim() != dim or x.numel() and (
            x.stride(-1) != 1 or min(x.stride()) < 0):
        raise ZippyError(f"{name} must be a {dim}-D {dtype} tensor with "
                         f"contiguous rows, got {tuple(x.shape)} {x.dtype} "
                         f"strides {x.stride()}")


def lz_resolve(packed, seg_out, words, sto, halo, used: int, nrounds: int,
               cfg) -> torch.Tensor:
    """One tile's output bytes (HALO + cfg.tile_out,) uint8: packed (k,
    lanes) int32, the tile's busy lanes' tokens as K4 packs them (columns
    may be a slice of a batch's); seg_out (lanes,) int32, each lane's first
    output position; words (nwords,) int32, the tile's stream words; sto
    (3, nsto) int32, its stored-span table (source byte in the words,
    output position, length; empty slots of length 0); halo (HALO,) uint8;
    used, the tile's output bytes; nrounds, the pointer-doubling rounds its
    depth needs (_nrounds_for_depth). out[:HALO + used] is what a caller
    reads. K6 on CUDA tensors (launches_per_tile(nrounds, used) launches),
    the plain version on CPU tensors."""
    _check(packed, "packed", 2)
    _check(seg_out, "seg_out", 1)
    _check(words, "words", 1)
    _check(sto, "sto", 2)
    _check(halo, "halo", 1, torch.uint8)
    k, lanes = packed.shape
    if not 1 <= k <= 1024 or seg_out.shape != (lanes,):
        raise ZippyError(f"expected packed (1..1024, lanes) and seg_out "
                         f"(lanes,), got {tuple(packed.shape)} and "
                         f"{tuple(seg_out.shape)}")
    if not words.shape[0] or sto.shape[0] != 3 or not sto.shape[1] \
            or not sto.is_contiguous() or halo.shape != (HALO,):
        raise ZippyError(f"expected words (nwords >= 1,), contiguous sto "
                         f"(3, nsto >= 1) and halo ({HALO},), got "
                         f"{tuple(words.shape)}, {tuple(sto.shape)} and "
                         f"{tuple(halo.shape)}")
    used, nrounds = int(used), int(nrounds)
    if not 0 <= used <= cfg.tile_out or not 0 <= nrounds <= 64:
        raise ZippyError(f"used {used} is not in 0..{cfg.tile_out} or "
                         f"nrounds {nrounds} not in 0..64")
    if len({x.device for x in (packed, seg_out, words, sto, halo)}) != 1:
        raise ZippyError("the inputs lie on different devices")
    dev = packed.device
    if dev.type == "cpu":
        return _resolve_plain(packed, seg_out, words, stored_spans(sto),
                              halo, nrounds, cfg)
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    out_pad = HALO + cfg.tile_out
    out = torch.empty(out_pad, dtype=torch.uint8, device=dev)
    state = torch.empty(max(used, 1), dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    rc = _lib().zt_lz_resolve(
        packed.data_ptr(), packed.stride(0), lanes, k, seg_out.data_ptr(),
        words.data_ptr(), words.shape[0], sto.data_ptr(), sto.shape[1],
        halo.data_ptr(), used, out_pad, nrounds, out.data_ptr(),
        state.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0,
        ctypes.byref(launched))
    LAUNCHES["lz_resolve"] += launched.value
    kernel_build.check_launch(rc, "lz_resolve")
    return out
