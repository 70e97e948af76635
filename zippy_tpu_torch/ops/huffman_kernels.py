"""The encoder's Huffman tables kernel (csrc/huffman.cu) and its wrapper.

K5 `huffman_tables` replaces the XLA code of zippy_tpu's encode_block
between find_tokens and pack_tokens (zippy_tpu/ops/deflate_device.py):
`_kraft_lengths` (:464) for the litlen, distance and code-length codes,
`_header_stats_device` (:596), `_rev_codes_device` (:582) and the
stored/fixed/dynamic choice (:676-700). One launch builds a group's tables,
one CTA a row (ROWS_PER_CTA), with every intermediate in registers or
shared memory: the torch ops of its plain version,
`deflate_device.huffman_tables_plain`, issue about 13,400 launches a group
and leave the card mostly idle. Its work is a few hundred thousand integer
operations and about 10 KB a row, so the launch and the chain of dependent
passes inside a row bound it, not bytes or operations. A row's warps work
in groups that synchronize alone: two groups of LL_WARPS warps build the
litlen code's two candidates side by side, and one warp the distance code
and then the code-length code (csrc/huffman.cu says how). Its outputs equal
the plain version's element for element: the ideal depths are computed the
same way (float32 ratio, float64 log2, rounded to float32) and nvcc may
contract no float step into an FMA.

The wrapper launches K5 on CUDA tensors (or raises) and runs the plain
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

LL_SYMS, D_SYMS, CL_SYMS = 286, 30, 19
# K5's layout (csrc/huffman.cu's kLLWarps, kRowsPerCta): the warps of each
# litlen candidate's group, and the rows a CTA builds; a CTA has
# THREADS = (2 * LL_WARPS + 1) * 32 threads.
LL_WARPS, ROWS_PER_CTA = 4, 1
THREADS = (2 * LL_WARPS + 1) * 32
# The fixed tables K5 reads, device_tables.CONSTS' names.
TABLES = ("fixed_ll", "fixed_ll_codes", "fixed_d", "fixed_d_codes",
          "len_extra", "dist_extra", "clcl_order", "cl_extra")
# Every output: (name, columns; 0 for one value a row).
OUTPUTS = (("ll_lens", LL_SYMS), ("d_lens", D_SYMS), ("cl_lens", CL_SYMS),
           ("mode", 0), ("use_ll", LL_SYMS), ("ll_codes", LL_SYMS),
           ("use_d", D_SYMS), ("d_codes", D_SYMS))


class _Args(ctypes.Structure):
    """csrc/huffman.cu's HuffmanArgs: device pointers, in its order."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("ll_hist", "dist_hist", "n", *TABLES,
                 *(name for name, _ in OUTPUTS))]


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("huffman.cu")))
    except OSError as e:
        raise ZippyError(f"cannot load the huffman kernel: {e}") from e
    lib.zt_huffman_tables.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int]
    lib.zt_huffman_tables.restype = ctypes.c_int
    return lib


def huffman_tables(ll_hist: torch.Tensor, dist_hist: torch.Tensor,
                   n: torch.Tensor) -> dict:
    """The Huffman tables of a group of blocks from their symbol histograms:
    ll_hist (G, 286), dist_hist (G, 30) and the blocks' byte counts n (G,),
    contiguous int64 on one device. Returns {name: tensor} for OUTPUTS,
    int64: the code lengths ll_lens, d_lens, cl_lens (dynamic header); mode
    (0 stored / 1 fixed / 2 dynamic); and the lengths and bit-reversed codes
    that pack_tokens takes, use_ll, ll_codes, use_d, d_codes (the dynamic
    code's where mode is 2, else the fixed code's). K5 on CUDA tensors (one
    launch of ceil(G / ROWS_PER_CTA) CTAs of THREADS threads),
    deflate_device.huffman_tables_plain on CPU tensors."""
    for x, name, shape in ((ll_hist, "ll_hist", (LL_SYMS,)),
                           (dist_hist, "dist_hist", (D_SYMS,)),
                           (n, "n", ())):
        if x.dtype != torch.int64 or x.shape[1:] != shape \
                or x.dim() != 1 + len(shape) or not x.is_contiguous():
            raise ZippyError(f"{name} must be a contiguous int64 (G, "
                             f"{', '.join(map(str, shape))}) tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
    rows = ll_hist.shape[0]
    if dist_hist.shape[0] != rows or n.shape[0] != rows:
        raise ZippyError(f"expected {rows} rows of each input, got "
                         f"{dist_hist.shape[0]} and {n.shape[0]}")
    if len({x.device for x in (ll_hist, dist_hist, n)}) != 1:
        raise ZippyError("the inputs lie on different devices")
    dev = ll_hist.device
    if dev.type == "cpu":
        from .deflate_device import huffman_tables_plain

        return huffman_tables_plain(ll_hist, dist_hist, n)
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    out = {name: torch.empty((rows, cols) if cols else (rows,),
                             dtype=torch.int64, device=dev)
           for name, cols in OUTPUTS}
    if rows:
        args = _Args(ll_hist.data_ptr(), dist_hist.data_ptr(), n.data_ptr(),
                     *(const(name, dev).data_ptr() for name in TABLES),
                     *(out[name].data_ptr() for name, _ in OUTPUTS))
        rc = _lib().zt_huffman_tables(
            ctypes.byref(args), rows,
            torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
        kernel_build.check_launch(rc, "huffman_tables")
        LAUNCHES["huffman_tables"] += 1
    return out
