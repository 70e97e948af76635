"""The encoder's stream join kernel (csrc/join.cu) and its plain version.

K10 `join_rows` replaces no TPU kernel: zippy_tpu joins its encoded blocks
on the host (`_assemble_block` over a `_ByteBitAppender`), and the port did
too, fetching every row's packed words whole. K10 joins the rows of one
encode group into one piece of the stream on the card, each row's 3 block
bits, dynamic header (K5's `hdr_words`) and payload (K8's `words`), or a
stored row's chunks from the group's own bytes, so that the host fetches
only the stream's bytes. The piece starts at a byte boundary of the stream,
at the group's start phase, which the previous group's join wrote into a
small per-run state (`new_state`): row g + 1 holds, after group g's join,

    phase   the next group's start phase, 0..7
    bits    the group's bits
    cut     the piece bit just past the block bits of the group's first
            stored row with a byte, or -1 (deflate_device._append_run)
    error   ERRORS' bits: what the join refused

Its plain version, `join_rows_plain`, places each row's segments at their
bit offsets with torch ops, as the host splice appended them. The two
write the same piece bytes up to the group's last bit and the same state
row.

The wrapper launches K10 on CUDA tensors (or raises) and runs the plain
version on CPU tensors. The kernel builds with nvcc at first CUDA use
(ops/kernel_build.py); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..common import ZippyError
from . import kernel_build
from .huffman_kernels import HDR_WORDS
from .kernel_build import LAUNCHES

# csrc/join.cu's kMaxRows: the rows of a group (deflate_device.MAX_GROUP).
MAX_ROWS = 64
STORED_CHUNK = 0xFFFF
# The state's columns, and the bits of its error word (csrc/join.cu's).
PHASE, BITS, CUT, ERROR = range(4)
ERRORS = {1: "a block's bits overflow its packed words",
          2: "a dynamic header's bits overflow its words",
          4: "a block mode is not stored, fixed or dynamic",
          8: "a block is longer than its row",
          16: "a group's bits overflow its piece"}


def row_bytes(block_size: int) -> int:
    """The most bytes a row of `block_size` bytes takes in the stream: its
    stored form, chunks of 5 bytes of framing, with 3 block bits and up to
    7 pad bits (K5 never picks a longer form)."""
    return block_size + 5 * -(-block_size // STORED_CHUNK) + 2


def piece_words(rows: int, block_size: int) -> int:
    """The 32-bit words of a group's piece: its rows' bytes and the start
    phase's byte."""
    return -(-(rows * row_bytes(block_size) + 1) // 4)


def new_state(groups: int, device) -> torch.Tensor:
    """A run's state: (groups + 1, 4) int64 zeros, so its first group
    starts at phase 0."""
    return torch.zeros(groups + 1, 4, dtype=torch.int64, device=device)


def _rows(res: dict, lens: torch.Tensor, raw: torch.Tensor, offset: int,
          block_size: int) -> list:
    """Each row's (mode, payload bits, header bits, block bytes) as K10
    reads them, clamped where they would read past their arrays, and the
    error word of what was clamped."""
    wn = res["words"].shape[1]
    len_max = min(block_size, raw.shape[1] - offset)
    rows, err = [], 0
    for m, nb, hb, n in zip(*(t.tolist() for t in (
            res["mode"], res["nbits"], res["hdr_bits"], lens))):
        if not 0 <= m <= 2:
            err, m = err | 4, 1
        hb = hb if m == 2 else 0
        if not 0 <= nb <= 32 * wn:
            err, nb = err | 1, min(max(nb, 0), 32 * wn)
        if not 0 <= hb <= 32 * HDR_WORDS:
            err, hb = err | 2, min(max(hb, 0), 32 * HDR_WORDS)
        if not 0 <= n <= len_max:
            err, n = err | 8, min(max(n, 0), len_max)
        rows.append((m, nb, hb, n))
    return rows, err


def _place(acc: torch.Tensor, at: int, src: torch.Tensor, nbits: int):
    """OR the first `nbits` bits of `src` (LSB-first bytes) into `acc` (one
    int32 a byte) from bit `at` on."""
    m = -(-nbits // 8)
    if m == 0:
        return
    v = src[:m].to(torch.int32)
    if nbits % 8:
        v[-1] &= (1 << nbits % 8) - 1
    q, sh = at >> 3, at & 7
    acc[q:q + m] |= (v << sh) & 0xFF
    if sh:
        acc[q + 1:q + m + 1] |= v >> (8 - sh)


def _int_bytes(value: int, nbits: int) -> torch.Tensor:
    return torch.tensor(list(value.to_bytes(-(-nbits // 8), "little")),
                        dtype=torch.uint8)


def join_rows_plain(res: dict, lens: torch.Tensor, raw: torch.Tensor,
                    offset: int, block_size: int, last: int,
                    state: torch.Tensor, group: int) -> torch.Tensor:
    """Plain version of K10 (join_rows): the same arguments, the same
    piece bytes up to the group's last bit (zeros after it) and the same
    state row group + 1, for CPU tensors. Each row's segments are placed
    one after another from the group's start phase, as the host splice
    appends them (deflate_device._append_block)."""
    rows, err = _rows(res, lens, raw, offset, block_size)
    hdr = res["hdr_words"].view(torch.uint8)
    payload = res["words"].view(torch.uint8)
    x0 = x = int(state[group, PHASE])
    cut, placed = -1, []
    for j, (m, nb, hb, n) in enumerate(rows):
        final = int(j == last)
        if m != 0:
            placed.append((x, _int_bytes(final | (2 if m == 1 else 4), 3),
                           3))
            x += 3
            if m == 2:
                placed.append((x, hdr[j], hb))
                x += hb
            placed.append((x, payload[j], nb))
            x += nb
            continue
        for off in range(0, n, STORED_CHUNK):
            chunk = min(n - off, STORED_CHUNK)
            if cut < 0:
                cut = x + 3
            pad = -(x + 3) % 8
            head = ((final and off + chunk == n)
                    | chunk << (3 + pad) | (chunk ^ 0xFFFF) << (19 + pad))
            placed.append((x, _int_bytes(head, 35 + pad), 35 + pad))
            x += 35 + pad
            start = offset + off
            placed.append((x, raw[j, start:start + chunk], 8 * chunk))
            x += 8 * chunk
    cap = 4 * piece_words(len(rows), block_size)
    if x > 8 * cap:
        err |= 16
    acc = torch.zeros(max(cap, -(-x // 8)) + 1, dtype=torch.int32)
    for at, src, nbits in placed:
        _place(acc, at, src, nbits)
    state[group + 1] = torch.tensor([x & 7, x - x0, cut, err])
    return acc[:cap].to(torch.uint8)


class _Args(ctypes.Structure):
    """csrc/join.cu's JoinArgs: device pointers, in its order."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "mode", "nbits", "hdr_bits", "lens", "hdr_words", "words", "raw",
        "state", "piece")]


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("join.cu")))
    except OSError as e:
        raise ZippyError(f"cannot load the join kernel: {e}") from e
    i32, i64 = ctypes.c_int, ctypes.c_longlong
    lib.zt_join_rows.argtypes = [ctypes.POINTER(_Args), i32, i32, i64, i64,
                                 i64, i32, i32, i64, ctypes.c_void_p, i32]
    lib.zt_join_rows.restype = i32
    return lib


def _check(res: dict, lens: torch.Tensor, raw: torch.Tensor, offset: int,
           block_size: int, last: int, state: torch.Tensor,
           group: int) -> int:
    """The group's rows G, or ZippyError."""
    G = lens.shape[0] if lens.dim() == 1 else -1
    if not 1 <= G <= MAX_ROWS:
        raise ZippyError(f"a group of {G} rows: K10 takes 1..{MAX_ROWS}")
    for name, x, dtype, shape in (
            ("mode", res["mode"], torch.int64, (G,)),
            ("nbits", res["nbits"], torch.int64, (G,)),
            ("hdr_bits", res["hdr_bits"], torch.int64, (G,)),
            ("hdr_words", res["hdr_words"], torch.int32, (G, HDR_WORDS)),
            ("lens", lens, torch.int64, (G,))):
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ZippyError(f"{name} must be a contiguous {dtype} "
                             f"{shape} tensor, got {tuple(x.shape)} {x.dtype}")
    words = res["words"]
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[0] != G or not words.is_contiguous():
        raise ZippyError("words must be a contiguous int32 (G, Wn) tensor")
    if raw.dtype != torch.uint8 or raw.dim() != 2 or raw.shape[0] != G \
            or not raw.is_contiguous() or not 0 <= offset < raw.shape[1]:
        raise ZippyError("raw must be a contiguous uint8 (G, W) tensor "
                         "holding each block from `offset` on")
    if state.dtype != torch.int64 or state.dim() != 2 \
            or state.shape[1] != 4 or not state.is_contiguous() \
            or not 0 <= group < state.shape[0] - 1:
        raise ZippyError(f"state must be a contiguous int64 (groups + 1, "
                         f"4) tensor with a row past group {group}")
    if not -1 <= last < G or block_size < 1:
        raise ZippyError(f"last row {last} of {G}, block_size {block_size}")
    tensors = (res["mode"], res["nbits"], res["hdr_bits"], res["hdr_words"],
               words, lens, raw, state)
    if len({x.device for x in tensors}) != 1:
        raise ZippyError("the inputs lie on different devices")
    return G


def join_rows(res: dict, lens: torch.Tensor, raw: torch.Tensor, offset: int,
              block_size: int, last: int, state: torch.Tensor,
              group: int) -> torch.Tensor:
    """Join an encode group's rows into one piece of its stream. `res` is
    deflate_device._encode_group's dict (mode, nbits, hdr_bits (G,) int64;
    hdr_words (G, HDR_WORDS) and words (G, Wn) int32), `lens` the blocks'
    bytes (G,) int64, `raw` the group's rows (G, W) uint8 with each block
    from byte `offset` on (read for a stored row), `block_size` the largest
    block, `last` the row of the stream's last block (-1: none), `state` the
    run's new_state, whose row `group` gives the start phase. Returns the
    piece, piece_words(G, block_size) words as uint8, and writes state row
    group + 1 (the module's docstring). K10 on CUDA tensors (one launch),
    join_rows_plain on CPU tensors."""
    G = _check(res, lens, raw, offset, block_size, last, state, group)
    dev = lens.device
    if dev.type == "cpu":
        return join_rows_plain(res, lens, raw, offset, block_size, last,
                               state, group)
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    cap = piece_words(G, block_size)
    piece = torch.empty(cap, dtype=torch.int32, device=dev)
    args = _Args(*(res[name].data_ptr() for name in (
        "mode", "nbits", "hdr_bits")), lens.data_ptr(),
        res["hdr_words"].data_ptr(), res["words"].data_ptr(),
        raw.data_ptr(), state.data_ptr(), piece.data_ptr())
    rc = _lib().zt_join_rows(
        ctypes.byref(args), G, res["words"].shape[1], raw.shape[1], offset,
        block_size, last, group, cap,
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    kernel_build.check_launch(rc, "join_rows")
    LAUNCHES["join_rows"] += 1
    return piece.view(torch.uint8)
