"""The encoder's bit packing kernel (csrc/pack.cu) and its plain version.

K8 `pack_tokens` replaces the jnp/XLA `pack_tokens` of
zippy_tpu/ops/deflate_device.py (:361): each row's token cover serialized
to a DEFLATE bit stream with the row's code tables, the end-of-block code
appended. One launch packs a group: as many CTAs as the card holds at
once work through the rows' chunks of CHUNK positions, taken by ticket,
each loading its next chunk while it writes this one; the chunks of a row
meet by decoupled look-back on a scan of (bit count, last 32 bits) pairs,
and each thread stores the words whose last bit is its own (csrc/pack.cu
says how). Its plain version, `pack_tokens_plain`,
is the torch ops the port ran before it: per-token bit lengths, their
prefix sum, and a scatter-add of the shifted code words. The two are equal
element for element on every token cover: int32 words holding the uint32
words' bit patterns, the form the encoder's fetch hands the host splice.

The wrapper launches K8 on CUDA tensors (or raises) and runs the plain
version on CPU tensors. The kernel builds with nvcc at first CUDA use
(ops/kernel_build.py); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..common import ZippyError
from . import kernel_build
from .device_tables import const
from .kernel_build import LAUNCHES
from .match_kernels import _M32, _to_i32

LL_SYMS, D_SYMS = 286, 30
# csrc/pack.cu's kChunk (positions a CTA) and kMaxChunks (chunks a row).
CHUNK, MAX_CHUNKS = 4096, 32
MAX_N = CHUNK * MAX_CHUNKS
# The token cover's (G, N) inputs, in csrc/pack.cu's PackArgs order.
TOKEN_INPUTS = (("is_tok", torch.bool), ("is_match", torch.bool),
                ("sym", torch.int64), ("len_idx", torch.int64),
                ("dist_idx", torch.int64), ("length", torch.int64),
                ("dist", torch.int64))
# The constant tables K8 reads, device_tables.CONSTS' names.
TABLES = ("len_extra", "base_len", "dist_extra", "base_dist")


def words_per_row(n: int) -> int:
    """The words of a row of N positions: N // 2 + 8, more than its
    16 N + 15 bits at most need (csrc/pack.cu says why)."""
    return n // 2 + 8


def pack_tokens_plain(tok: dict, ll_lens: torch.Tensor,
                      ll_codes: torch.Tensor, dist_lens: torch.Tensor,
                      dist_codes: torch.Tensor):
    """Plain version of K8 (pack_tokens), torch ops: the four components'
    bit lengths and values of every position, their prefix sum, and a
    scatter-add of the shifted code words (codes never overlap, so the sum
    is the bitwise OR; a word index past the row clamps to its last word,
    as the reference's does). The words are returned as int32 bit
    patterns, as K8 writes them."""
    is_tok, m = tok["is_tok"], tok["is_match"]
    sym, len_idx, dist_idx = tok["sym"], tok["len_idx"], tok["dist_idx"]
    dev = is_tok.device
    G, N = is_tok.shape
    # Four components per token (a literal uses only c0).
    c_bits = [
        torch.where(is_tok, ll_lens.gather(1, sym), 0),
        torch.where(m, const("len_extra", dev)[len_idx], 0),
        torch.where(m, dist_lens.gather(1, dist_idx), 0),
        torch.where(m, const("dist_extra", dev)[dist_idx], 0),
    ]
    c_vals = [
        torch.where(is_tok, ll_codes.gather(1, sym), 0),
        torch.where(m, tok["length"] - const("base_len", dev)[len_idx], 0),
        torch.where(m, dist_codes.gather(1, dist_idx), 0),
        torch.where(m, tok["dist"] - const("base_dist", dev)[dist_idx], 0),
    ]
    nbits = c_bits[0] + c_bits[1] + c_bits[2] + c_bits[3]
    off0 = torch.cumsum(nbits, dim=1) - nbits
    body_bits = off0[:, -1:] + nbits[:, -1:]                   # (G, 1)

    # Append the end-of-block code (symbol 256) at the tail.
    eob_bits = ll_lens[:, 256:257]
    eob_val = ll_codes[:, 256:257]
    total_bits = (body_bits + eob_bits).squeeze(1)
    offs = [off0]
    for c in range(1, 4):
        offs.append(offs[-1] + c_bits[c - 1])

    Wn = words_per_row(N)
    zero = torch.zeros(G, 1, dtype=torch.int64, device=dev)
    all_lo, all_hi, all_w = [], [], []
    for c in range(4):
        bo = torch.cat([offs[c], body_bits], dim=1)
        bits_c = torch.cat([c_bits[c], eob_bits if c == 0 else zero], dim=1)
        val_c = torch.cat([c_vals[c], eob_val if c == 0 else zero], dim=1)
        val_c = torch.where(bits_c > 0, val_c, 0)
        sh = bo & 31
        all_lo.append((val_c << sh) & _M32)
        all_hi.append(torch.where(sh == 0, 0, val_c >> (32 - sh)))
        all_w.append(bo >> 5)
    vals = torch.cat(all_lo + all_hi, dim=1)
    segs = torch.cat(all_w + [w + 1 for w in all_w], dim=1).clamp(0, Wn - 1)
    # Codes never overlap, so the integer sum is the bitwise OR (a clipped
    # tail wraps mod 2^32, as the reference's uint32 sum does).
    words = torch.zeros(G, Wn, dtype=torch.int64, device=dev).scatter_add_(
        1, segs, vals) & _M32
    return _to_i32(words), total_bits


class _Args(ctypes.Structure):
    """csrc/pack.cu's PackArgs: device pointers, in its order."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        *(name for name, _ in TOKEN_INPUTS), "ll_lens", "ll_codes",
        "d_lens", "d_codes", *TABLES, "words", "total_bits", "scratch")]


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("pack.cu")))
    except OSError as e:
        raise ZippyError(f"cannot load the pack kernel: {e}") from e
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zt_pack_tokens.argtypes = [ctypes.POINTER(_Args), i32, i32, i32, i64,
                                   i64, p, i32]
    lib.zt_pack_tokens.restype = i32
    return lib


# K8's look-back flags and counters, one buffer per (device, stream handle),
# the only state the kernel wrappers keep across calls. The invariant: the
# buffer is all zero when a launch starts. It is zeroed once, when made,
# and each launch's last CTA to leave (after every CTA has taken its last
# ticket) zeroes it again; launches on one stream run one after another, so
# each finds it zero, and launches on two streams never share one. What
# would break it: a launch that aborts before its last CTA leaves (its
# CUDA context is then lost as well), or a stream handle that is freed and
# handed out again while a launch on the old stream is still in flight. A buffer made during CUDA-graph capture
# is zeroed only when the graph first replays (each replay then leaves it
# zero), so such a graph must replay before K8 runs eagerly on its capture
# stream.
_scratches: dict = {}


def _scratch(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (dev.index or 0, stream)
    buf = _scratches.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int64, device=dev)
        _scratches[key] = buf
    return buf


def _check(tok: dict, tables) -> tuple[int, int]:
    """(G, N) of a token cover and its tables, or ZippyError."""
    shapes = []
    for name, dtype in TOKEN_INPUTS:
        x = tok.get(name)
        if not isinstance(x, torch.Tensor) or x.dtype != dtype \
                or x.dim() != 2 or not x.is_contiguous():
            raise ZippyError(f"tok[{name!r}] must be a contiguous 2-D "
                             f"{dtype} tensor")
        shapes.append(tuple(x.shape))
    G, N = shapes[0]
    if any(s != (G, N) for s in shapes):
        raise ZippyError(f"the token cover's tensors differ in shape: "
                         f"{shapes}")
    if not 1 <= N <= MAX_N:
        raise ZippyError(f"rows of {N} positions: K8 takes 1..{MAX_N}")
    for x, name, cols in zip(tables, ("ll_lens", "ll_codes", "dist_lens",
                                      "dist_codes"),
                             (LL_SYMS, LL_SYMS, D_SYMS, D_SYMS)):
        if x.dtype != torch.int64 or x.shape != (G, cols) \
                or x.stride(1) != 1:
            raise ZippyError(f"{name} must be an int64 ({G}, {cols}) tensor "
                             f"with contiguous rows, got {tuple(x.shape)} "
                             f"{x.dtype}")
    if tables[0].stride() != tables[1].stride() \
            or tables[2].stride() != tables[3].stride():
        raise ZippyError("a code table's lengths and codes differ in layout")
    if len({x.device for x in (*(tok[n] for n, _ in TOKEN_INPUTS),
                               *tables)}) != 1:
        raise ZippyError("the inputs lie on different devices")
    return G, N


def pack_tokens(tok: dict, ll_lens: torch.Tensor, ll_codes: torch.Tensor,
                dist_lens: torch.Tensor, dist_codes: torch.Tensor):
    """Serialize each row's token cover to a DEFLATE bit stream (no 3-bit
    block header): tok holds find_tokens' (G, N) tensors (TOKEN_INPUTS,
    contiguous, 1 <= N <= MAX_N), the tables are (G, 286) and (G, 30) int64
    code lengths (0..15) and bit-reversed codes, rows contiguous. Returns
    (words (G, N // 2 + 8) int32 holding the uint32 words' bit patterns,
    zero past each row's last bit, total_bits (G,) int64). Bit k of a row's stream is bit
    (k % 32) of word (k // 32). K8 on CUDA tensors (one launch; none for
    G = 0), pack_tokens_plain on CPU tensors."""
    tables = (ll_lens, ll_codes, dist_lens, dist_codes)
    G, N = _check(tok, tables)
    dev = tok["is_tok"].device
    if dev.type == "cpu":
        return pack_tokens_plain(tok, *tables)
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    wn = words_per_row(N)
    words = torch.empty(G, wn, dtype=torch.int32, device=dev)
    total_bits = torch.empty(G, dtype=torch.int64, device=dev)
    if G:
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch(dev, stream, G * -(-N // CHUNK) + 1)
        args = _Args(*(tok[name].data_ptr() for name, _ in TOKEN_INPUTS),
                     *(x.data_ptr() for x in tables),
                     *(const(name, dev).data_ptr() for name in TABLES),
                     words.data_ptr(), total_bits.data_ptr(),
                     scratch.data_ptr())
        rc = _lib().zt_pack_tokens(
            ctypes.byref(args), G, N, wn, ll_lens.stride(0),
            dist_lens.stride(0), stream, dev.index or 0)
        kernel_build.check_launch(rc, "pack_tokens")
        LAUNCHES["pack_tokens"] += 1
    return words, total_bits
