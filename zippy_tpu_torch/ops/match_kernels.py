"""The encoder's match finding kernel (csrc/match.cu) and its plain
PyTorch version.

K7 `match_tokens` replaces the jnp/XLA `find_tokens` of
zippy_tpu/ops/deflate_device.py (:94-360): the token cover of a group of
blocks. Per position: the k most recent earlier positions with the same
4-byte hash (from the sort of the keys (hash << 17 | pos)), their match
lengths (for k >= 4 ranked on 32 bytes, the top three rescored on 64;
else each on 64), the extension of a 64-byte match toward 258, under
`min3` the length-3 match of the most recent same 3-gram within 4096
bytes, the lazy rule, and the token cover, the walk from position 0 by
each token's length; then each token's symbol, length and distance codes
and the litlen and distance histograms. Level -2 (`lits_only`) makes
every byte a literal.

The plain version, `find_tokens_plain`, computes it with torch ops that
materialise every candidate's byte windows (gigabytes a group on the
card). K7 computes the same outputs element for element in
`LAUNCHES_PER_GROUP` launches of its own, the key sort included
(csrc/match.cu says how), holding no window tensor; under `lits_only` it
is one launch (`LAUNCHES_LITS_ONLY`). `sort_keys` runs K7's sort alone,
and `sort_keys_plain` is its plain version.

The wrappers launch K7 on CUDA tensors (or raise) and run the plain
versions on CPU tensors. The kernel builds with nvcc at first CUDA use
(ops/kernel_build.py); importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import tables
from ..common import ZippyError
from . import kernel_build
from .device_tables import const
from .kernel_build import LAUNCHES

L_CMP = 64                      # match length scored during candidate ranking
L_EXT = 194                     # second-phase extension (to the 258 cap)
PAD = 264                       # input padding past the block (>= L_CMP+L_EXT)
HASH_BITS = 15

NWIN = L_CMP // 4 + 1           # 64-byte cap + slack word
NRANK = 8                       # words ranked per candidate when k >= 4
EXTW = L_EXT // 4 + 2           # 194 bytes + slack

_M32 = 0xFFFFFFFF
_HASH_MUL = 0x9E3779B1

MAX_K = 32                      # the most candidates K7 holds a position
# count, scan, scatter, hist, scan, scatter (the sort); match; exits, chain,
# emit (the cover)
LAUNCHES_PER_GROUP = 10
LAUNCHES_SORT = 6
LAUNCHES_LITS_ONLY = 1
# csrc/match.cu's scratch shapes: keys a sort tile, positions a cover
# chunk, a chunk's row of exits.
SORT_TILE = 4096
CHUNK = 1024
EXIT_STRIDE = 264


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for int64 v in [0, 2^32), without int64 overflow:
    the constant is split in 16-bit halves."""
    return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit values -> int32 with the same bit pattern."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _words(data_pad: torch.Tensor, NA: int) -> torch.Tensor:
    """(G, NA) int64: the little-endian word at each hashable position."""
    b = data_pad.long()
    return (b[:, :NA] | (b[:, 1:NA + 1] << 8) | (b[:, 2:NA + 2] << 16)
            | (b[:, 3:NA + 3] << 24))


def _hash(v: torch.Tensor) -> torch.Tensor:
    return _mul32(v, _HASH_MUL) >> (32 - HASH_BITS)


def _windows(flat: torch.Tensor, nwords: int) -> torch.Tensor:
    """View V[p, t] = flat[p + 4t], t < nwords (no copy)."""
    return flat.unfold(0, 4 * (nwords - 1) + 1, 1)[:, ::4]


def _first_diff(xi: torch.Tensor, xj: torch.Tensor, nwords: int,
                cap: int) -> torch.Tensor:
    """Byte index of the first mismatch between two int32 word windows
    (exactly the byte loop's answer), capped at `cap`. Count-trailing-zeros
    of the first differing word comes from bit tests on its lowest set bit:
    torch has no popcount, and a float log2 would round."""
    x = xi ^ xj
    nz = x != 0
    anyx = nz.any(dim=-1)
    fw = torch.argmax(nz.to(torch.uint8), dim=-1)       # first differing word
    xw = x.gather(-1, fw.unsqueeze(-1)).squeeze(-1)
    low = xw & -xw
    inner = (((low & -(1 << 8)) != 0).long() + ((low & -(1 << 16)) != 0).long()
             + ((low & -(1 << 24)) != 0).long())
    return torch.where(anyx, 4 * fw + inner, 4 * nwords).clamp(max=cap)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def find_tokens_plain(data_pad: torch.Tensor, n, hist_len=0, *, k: int = 4,
                      lazy: bool = True, hist: int = 0, min3: bool = False,
                      lits_only: bool = False) -> dict:
    """Token cover of a group of blocks.

    data_pad: (G, hist + N + PAD) uint8 — per row an optional read-only
    `hist`-byte prefix (the raw bytes before the block), then the block,
    zero padded past `n`. `n` and `hist_len` (how many prefix bytes are
    real) are per row. Returns a dict of (G, N) tensors: is_tok, is_match,
    length, dist, sym, len_idx, dist_idx; and the (G, 286) litlen and
    (G, 30) dist histograms. The plain version of K7 (match_tokens): the
    torch ops of the reference's find_tokens."""
    G, D = data_pad.shape
    N = D - PAD - hist
    NA = hist + N                   # all hashable positions (sources)
    if NA > (1 << 17):              # pos fits 17 bits of the sort key
        raise ZippyError(f"hist + block of {NA} bytes exceeds 2^17")
    dev = data_pad.device
    i64 = torch.int64
    n = torch.as_tensor(n, dtype=i64, device=dev).reshape(-1, 1).expand(G, 1)
    hist_len = torch.as_tensor(hist_len, dtype=i64,
                               device=dev).reshape(-1, 1).expand(G, 1)
    i_rel = torch.arange(N, dtype=i64, device=dev)
    lit_sym = data_pad[:, hist:hist + N].long()
    if lits_only:
        # HuffmanOnly (level -2): every byte a literal token.
        is_tok = i_rel < n
        zeros = torch.zeros(G, N, dtype=i64, device=dev)
        ll_hist = torch.zeros(G, 286, dtype=i64, device=dev).scatter_add_(
            1, lit_sym, is_tok.long())
        ll_hist[:, 256] += 1
        return {
            "is_tok": is_tok,
            "is_match": torch.zeros(G, N, dtype=torch.bool, device=dev),
            "length": zeros,
            "dist": zeros + 1,
            "sym": lit_sym,
            "len_idx": zeros,
            "dist_idx": zeros,
            "ll_hist": ll_hist,
            "dist_hist": torch.zeros(G, 30, dtype=i64, device=dev),
        }

    b = data_pad.long()
    v = _words(data_pad, NA)
    h = _hash(v)
    pos = torch.arange(NA, dtype=i64, device=dev)

    # Sort positions by (hash, pos): bucket predecessors = recent occurrences.
    order = torch.argsort((h << 17) | pos, dim=1)
    h_sorted = h.gather(1, order)
    cands = []
    for back in range(1, k + 1):
        prev_pos = torch.roll(order, back, dims=1)
        same_bucket = torch.roll(h_sorted, back, dims=1) == h_sorted
        valid = (pos >= back) & same_bucket
        cands.append(torch.where(valid, prev_pos, -1))
    cands_sorted = torch.stack(cands, dim=2)                   # (G, NA, k)
    cands_pos = torch.zeros_like(cands_sorted).scatter_(
        1, order.unsqueeze(2).expand(G, NA, k), cands_sorted)[:, hist:]

    i_abs = i_rel + hist            # data_pad index (reads)

    # Word windows: W[p] = LE word at byte p, as int32 bit patterns. The
    # i-side windows are strided views; the candidate side gathers rows of
    # a strided view of the flattened group, offset by each row's base.
    DW = D - 3
    W = _to_i32(b[:, :DW] | (b[:, 1:DW + 1] << 8) | (b[:, 2:DW + 2] << 16)
                | (b[:, 3:DW + 3] << 24))
    Wf = W.reshape(-1)
    base = (torch.arange(G, dtype=i64, device=dev) * DW).view(G, 1, 1)
    wiw = W[:, hist:].unfold(1, 4 * (NWIN - 1) + 1, 1)[:, :N, ::4]

    def gather_windows(start, nwords):
        # Explicit clamp: every start lies in its own row (largest window
        # end is hist + N + 259 of DW = hist + N + 261 words).
        start = start.clamp(0, DW - 4 * (nwords - 1) - 1)
        return _windows(Wf, nwords)[base.view((G,) + (1,) * (start.dim() - 1))
                                    + start]

    cj = cands_pos.clamp(min=0)
    dist = i_abs.view(1, N, 1) - cands_pos                     # (G, N, k)
    # Candidates inside the unreal part of the prefix (< hist - hist_len)
    # would match padding zeros; exclude them along with -1 sentinels.
    ok = ((cands_pos >= hist - hist_len.view(G, 1, 1)) & (cands_pos >= 0)
          & (dist <= tables.MAX_WINDOW_SIZE))
    nrem = (n - i_rel).clamp(min=0)                            # (G, N)

    if k >= 4:
        # Rank all k on 32 bytes, rescore the top three at the 64-byte cap.
        ar = torch.arange(k, dtype=i64, device=dev)
        mlen_r = _first_diff(wiw[:, :, None, :NRANK],
                             gather_windows(cj, NRANK), NRANK, 4 * NRANK)
        mlen_r = torch.where(ok, mlen_r, 0)
        score_r = (mlen_r << 17) + cands_pos
        b1 = score_r.argmax(dim=2)
        score_r2 = torch.where(b1.unsqueeze(2) == ar, -1, score_r)
        b2 = score_r2.argmax(dim=2)
        score_r3 = torch.where(b2.unsqueeze(2) == ar, -1, score_r2)
        b3 = score_r3.argmax(dim=2)
        pick = torch.stack([b1, b2, b3], dim=2)                # (G, N, 3)
        cand2 = cands_pos.gather(2, pick)
        ok2 = ok.gather(2, pick)
        mlen2 = _first_diff(wiw[:, :, None, :],
                            gather_windows(cand2.clamp(min=0), NWIN),
                            NWIN, L_CMP)
        mlen2 = torch.where(ok2, mlen2, 0)
        mlen2 = torch.minimum(mlen2, nrem.unsqueeze(2))
        score2 = (mlen2 << 17) + cand2
        bb = score2.argmax(dim=2, keepdim=True)
        l_best = mlen2.gather(2, bb).squeeze(2)
        d_best = i_abs - cand2.gather(2, bb).squeeze(2)
    else:
        mlen = _first_diff(wiw[:, :, None, :], gather_windows(cj, NWIN),
                           NWIN, L_CMP)                        # (G, N, k)
        mlen = torch.where(ok, mlen, 0)
        # Don't run past the real end of the block.
        mlen = torch.minimum(mlen, nrem.unsqueeze(2))
        # Best candidate: longest match, then nearest (larger j).
        score = (mlen << 17) + cands_pos
        best = score.argmax(dim=2, keepdim=True)
        l_best = mlen.gather(2, best).squeeze(2)
        d_best = dist.gather(2, best).squeeze(2)

    # Second phase: matches that hit the L_CMP cap extend toward 258.
    j_best = i_abs - d_best
    we_i = W[:, hist + L_CMP:].unfold(1, 4 * (EXTW - 1) + 1, 1)[:, :N, ::4]
    we_j = gather_windows(j_best.clamp(min=0) + L_CMP, EXTW)
    ext = _first_diff(we_i, we_j, EXTW, L_EXT)
    l_best = torch.where(l_best == L_CMP, l_best + ext, l_best)
    l_best = torch.minimum(l_best, nrem.clamp(max=tables.MAX_MATCH_LEN))

    is_m = l_best >= 4
    if min3:
        # Length-3 matches at short distance (zlib's TOO_FAR = 4096 rule):
        # one recency candidate from a 3-gram sort.
        h3 = _hash(v & 0xFFFFFF)
        order3 = torch.argsort((h3 << 17) | pos, dim=1)
        h3s = h3.gather(1, order3)
        prev3 = torch.roll(order3, 1, dims=1)
        same3 = (torch.roll(h3s, 1, dims=1) == h3s) & (pos >= 1)
        c3 = torch.zeros_like(order3).scatter_(
            1, order3, torch.where(same3, prev3, -1))[:, hist:]
        cj3 = c3.clamp(min=0)
        d3 = i_abs - c3
        eq3 = ((data_pad[:, hist:hist + N] == data_pad.gather(1, cj3))
               & (data_pad[:, hist + 1:hist + N + 1]
                  == data_pad.gather(1, cj3 + 1))
               & (data_pad[:, hist + 2:hist + N + 2]
                  == data_pad.gather(1, cj3 + 2)))
        ok3 = (eq3 & (c3 >= hist - hist_len) & (c3 >= 0) & (d3 <= 4096)
               & ((n - i_rel) >= 3))
        # If position i+2 starts a real (>= 4) match, three literals and
        # that match beat the 3-match: demote those up front.
        l_at_2 = torch.roll(l_best, -2, dims=1)
        l_at_2[:, -2:] = 0
        take3 = ok3 & ~is_m & ~(l_at_2 >= 4)
        l_best = torch.where(take3, 3, l_best)
        d_best = torch.where(take3, d3, d_best)
        is_m = is_m | take3
    if lazy:
        nxt_l = torch.roll(l_best, -1, dims=1)
        nxt_l[:, -1] = 0
        is_m = is_m & ~(nxt_l > l_best)

    # Pointer-doubling reachability from position 0.
    step = torch.where(is_m, l_best, 1)
    nxt = (i_rel + step).clamp(max=N)
    nxt = torch.where(i_rel >= n, N, nxt)
    J = torch.cat([nxt, torch.full((G, 1), N, dtype=i64, device=dev)], dim=1)
    reach = torch.zeros(G, N + 1, dtype=torch.bool, device=dev)
    reach[:, 0] = True
    for _ in range(int(np.ceil(np.log2(N))) + 1):
        reach = reach.scatter(1, torch.where(reach, J, N), True)
        J = J.gather(1, J)

    is_tok = reach[:, :N] & (i_rel < n)
    is_match = is_tok & is_m
    length = torch.where(is_match, l_best, 0)
    dist_b = torch.where(is_match, d_best, 1)

    # Symbols + histograms.
    len_idx = const("len_idx", dev)[(length - 3).clamp(0, 255)]
    d1 = dist_b - 1
    lut = const("dist_lut", dev)
    dist_idx = torch.where(dist_b <= 256, lut[d1.clamp(0, 255)],
                           lut[(256 + (d1 >> 7)).clamp(0, 511)])
    sym = torch.where(is_match, 257 + len_idx, lit_sym)
    ll_hist = torch.zeros(G, 286, dtype=i64, device=dev).scatter_add_(
        1, sym, is_tok.long())
    ll_hist[:, 256] += 1            # end-of-block symbol
    dist_hist = torch.zeros(G, 30, dtype=i64, device=dev).scatter_add_(
        1, dist_idx, is_match.long())
    return {
        "is_tok": is_tok,
        "is_match": is_match,
        "length": length,
        "dist": dist_b,
        "sym": sym,
        "len_idx": len_idx,
        "dist_idx": dist_idx,
        "ll_hist": ll_hist,
        "dist_hist": dist_hist,
    }


def _flip(u: torch.Tensor) -> torch.Tensor:
    """uint32 keys held in int64 -> int32 with the top bit flipped, whose
    int32 order is the keys' unsigned order (K7 sorts them so)."""
    return _to_i32(u ^ (1 << 31))


def _unflip(keys: torch.Tensor) -> torch.Tensor:
    return (keys.long() & _M32) ^ (1 << 31)


def hash_keys_plain(data_pad: torch.Tensor, min3: bool = False
                    ) -> torch.Tensor:
    """The keys K7 sorts, unsorted, as k7_count makes them: per row of
    data_pad (G, NA + PAD) uint8 the NA keys (hash << 17 | pos), flipped
    int32 (see _flip); under min3 G more rows, the 3-byte keys."""
    NA = data_pad.shape[1] - PAD
    v = _words(data_pad, NA)
    pos = torch.arange(NA, dtype=torch.int64, device=data_pad.device)
    hashes = [_hash(v)] + ([_hash(v & 0xFFFFFF)] if min3 else [])
    return torch.cat([_flip((h << 17) | pos) for h in hashes])


def sort_keys_plain(data_pad: torch.Tensor, hist: int = 0,
                    min3: bool = False) -> dict:
    """K7's sort stage, the plain version: per row of data_pad (G, NA +
    PAD) uint8, NA = hist + N, the NA keys (hash << 17 | pos) in order
    ("keys", (G, NA) flipped int32) and each block position's index in
    that order ("inv", (G, N) int32: positions hist ..); under min3 the
    same of the 3-byte keys ("keys3", "inv3") and each block position's
    3-gram candidate ("c3", (G, N) int64: the position before it in the
    3-byte order where the hash is the same, else -1), as
    find_tokens_plain computes them."""
    G = data_pad.shape[0]
    keys = hash_keys_plain(data_pad, min3)
    order = torch.argsort(keys, dim=1)
    pos = torch.arange(keys.shape[1], dtype=torch.int64,
                       device=data_pad.device)
    inv = torch.empty_like(order).scatter_(1, order, pos.expand_as(order))
    keys, inv = keys.gather(1, order), inv[:, hist:].to(torch.int32)
    out = {"keys": keys[:G], "inv": inv[:G]}
    if min3:
        out.update(keys3=keys[G:], inv3=inv[G:])
        order3, h3s = order[G:], _unflip(keys[G:]) >> 17
        same = (torch.roll(h3s, 1, dims=1) == h3s) & (pos >= 1)
        out["c3"] = torch.zeros_like(order3).scatter_(
            1, order3, torch.where(same, torch.roll(order3, 1, dims=1),
                                   -1))[:, hist:]
    return out


def candidates3(keys3: torch.Tensor, inv3: torch.Tensor) -> torch.Tensor:
    """Each block position's 3-gram candidate as k7_match reads it from the
    3-byte order: the key before the position's own in keys3, where its
    hash is the same, else -1. (G, N) int64, as inv3."""
    u = _unflip(keys3)
    s = inv3.long()
    prev = u.gather(1, (s - 1).clamp(min=0))
    same = (s >= 1) & ((prev >> 17) == (u.gather(1, s) >> 17))
    return torch.where(same, prev & ((1 << 17) - 1), -1)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

# (name, dtype) of every (G, N) output, in csrc/match.cu's MatchArgs order.
TOKEN_OUTPUTS = (("is_tok", torch.bool), ("is_match", torch.bool),
                 ("length", torch.int64), ("dist", torch.int64),
                 ("sym", torch.int64), ("len_idx", torch.int64),
                 ("dist_idx", torch.int64))


class _Args(ctypes.Structure):
    """csrc/match.cu's MatchArgs: device pointers, in its order."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "data", "n", "hist_len", "low", "sorted", "inv", "tiles", "lbest",
        "dbest", "m3", "exits", "entry", "len_tab", "dist_lut",
        *(name for name, _ in TOKEN_OUTPUTS), "ll_hist", "dist_hist")]

    @classmethod
    def of(cls, tensors: dict) -> "_Args":
        return cls(**{name: t.data_ptr() for name, t in tensors.items()})


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("match.cu")))
    except OSError as e:
        raise ZippyError(f"cannot load the match kernel: {e}") from e
    args, i32, p = ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p
    out = ctypes.POINTER(i32)
    lib.zt_match_sort.argtypes = [args, i32, i32, i32, i32, p, i32, out]
    lib.zt_match_tokens.argtypes = [args, i32, i32, i32, i32, i32, i32, p,
                                    i32, out]
    lib.zt_match_literals.argtypes = [args, i32, i32, i32, p, i32, out]
    for fn in (lib.zt_match_sort, lib.zt_match_tokens,
               lib.zt_match_literals):
        fn.restype = i32
    return lib


def launches_per_group(lits_only: bool) -> int:
    """K7's kernel launches for one group, its sort's included."""
    return LAUNCHES_LITS_ONLY if lits_only else LAUNCHES_PER_GROUP


def _check_rows(data_pad: torch.Tensor, n: torch.Tensor,
                hist_len: torch.Tensor, k: int, hist: int) -> None:
    if (data_pad.dtype != torch.uint8 or data_pad.dim() != 2
            or not data_pad.is_contiguous()):
        raise ZippyError(f"data_pad must be a contiguous 2-D uint8 tensor, "
                         f"got {tuple(data_pad.shape)} {data_pad.dtype}")
    G, D = data_pad.shape
    for x, name in ((n, "n"), (hist_len, "hist_len")):
        if x.dtype != torch.int64 or x.shape != (G,) \
                or not x.is_contiguous():
            raise ZippyError(f"{name} must be a contiguous int64 ({G},) "
                             f"tensor, got {tuple(x.shape)} {x.dtype}")
    if len({x.device for x in (data_pad, n, hist_len)}) != 1:
        raise ZippyError("the inputs lie on different devices")
    N = D - PAD - hist
    if hist < 0 or N < 1:
        raise ZippyError(f"rows of {D} bytes hold no block after a "
                         f"{hist}-byte history and {PAD} bytes of padding")
    if hist + N > (1 << 17):        # pos fits 17 bits of the sort key
        raise ZippyError(f"hist + block of {hist + N} bytes exceeds 2^17")
    if not 1 <= k <= MAX_K:
        raise ZippyError(f"k must lie in [1, {MAX_K}], got {k}")


def _sort_scratch(low: torch.Tensor, N: int) -> dict:
    """The sort's buffers for R = low.shape[0] rows of keys (G, and under
    min3 G more): `low`, the keys after its low pass, (R, NA) int32; the
    keys after both; inv; the tiles' histograms."""
    R, NA = low.shape
    i32, dev = torch.int32, low.device
    return {"low": low,
            "sorted": torch.empty(R, NA, dtype=i32, device=dev),
            "inv": torch.empty(R, N, dtype=i32, device=dev),
            "tiles": torch.empty(R, -(-NA // SORT_TILE), 256, dtype=i32,
                                 device=dev)}


def _call(fn, name: str, *args) -> None:
    launched = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(launched))
    LAUNCHES["match_tokens"] += launched.value
    kernel_build.check_launch(rc, name)


def _stream(dev) -> tuple:
    return torch.cuda.current_stream(dev).cuda_stream, dev.index or 0


def sort_keys(data_pad: torch.Tensor, hist: int = 0,
              min3: bool = False) -> dict:
    """K7's sort stage alone, sort_keys_plain's dict but for "c3"
    (candidates3 gives it): LAUNCHES_SORT launches of K7 on a CUDA
    tensor, counted as match_tokens', the plain version on a CPU one."""
    G, D = data_pad.shape
    n = torch.zeros(G, dtype=torch.int64, device=data_pad.device)
    _check_rows(data_pad, n, n, 1, hist)
    dev = data_pad.device
    if dev.type == "cpu":
        out = sort_keys_plain(data_pad, hist, min3)
        out.pop("c3", None)
        return out
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    NA = D - PAD
    low = torch.empty((2 if min3 else 1) * G, NA, dtype=torch.int32,
                      device=dev)
    ptrs = {"data": data_pad, **_sort_scratch(low, NA - hist)}
    args = _Args.of(ptrs)
    _call(_lib().zt_match_sort, "match_tokens", ctypes.byref(args), G, D,
          hist, int(min3), *_stream(dev))
    keys, inv = ptrs["sorted"], ptrs["inv"]
    out = {"keys": keys[:G], "inv": inv[:G]}
    if min3:
        out.update(keys3=keys[G:], inv3=inv[G:])
    return out


def match_tokens(data_pad: torch.Tensor, n: torch.Tensor,
                 hist_len: torch.Tensor, *, k: int, lazy: bool, hist: int,
                 min3: bool, lits_only: bool) -> dict:
    """find_tokens' dict for a group of rows: data_pad (G, hist + N + PAD)
    uint8, n and hist_len (G,) int64, contiguous, on one device. K7 on CUDA
    tensors (launches_per_group(lits_only) launches, no other device
    work), find_tokens_plain on CPU tensors."""
    _check_rows(data_pad, n, hist_len, k, hist)
    dev = data_pad.device
    if dev.type == "cpu":
        return find_tokens_plain(data_pad, n, hist_len, k=k, lazy=lazy,
                                 hist=hist, min3=min3, lits_only=lits_only)
    if dev.type != "cuda":
        raise ZippyError(f"unsupported device {dev}")
    G, D = data_pad.shape
    N = D - PAD - hist
    out = {name: torch.empty(G, N, dtype=dtype, device=dev)
           for name, dtype in TOKEN_OUTPUTS}
    out["ll_hist"] = torch.empty(G, 286, dtype=torch.int64, device=dev)
    out["dist_hist"] = torch.empty(G, 30, dtype=torch.int64, device=dev)
    if G == 0:
        return out
    lib = _lib()
    ptrs = {"data": data_pad, "n": n, "hist_len": hist_len,
            "len_tab": const("len_idx", dev),
            "dist_lut": const("dist_lut", dev), **out}
    if lits_only:
        args = _Args.of(ptrs)
        _call(lib.zt_match_literals, "match_tokens", ctypes.byref(args), G,
              D, hist, *_stream(dev))
        return out
    nch = -(-N // CHUNK)
    i32 = torch.int32
    # The low pass's keys are dead once the high pass has read them (launch
    # 6), so the match's best lengths, distances and (under min3) 3-gram
    # distances (launch 7 on) take their memory.
    R, NA, GN = (2 if min3 else 1) * G, hist + N, G * N
    work = torch.empty(max(R * NA, (3 if min3 else 2) * GN), dtype=i32,
                       device=dev)
    ptrs.update(_sort_scratch(work[:R * NA].view(R, NA), N))
    ptrs["lbest"] = work[:GN].view(G, N)
    ptrs["dbest"] = work[GN:2 * GN].view(G, N)
    ptrs["m3"] = (work[2 * GN:3 * GN] if min3 else work[:0]).view(-1, N)
    ptrs["exits"] = torch.empty(G, nch, EXIT_STRIDE, dtype=torch.int16,
                                device=dev)
    ptrs["entry"] = torch.empty(G, nch, dtype=i32, device=dev)
    args = _Args.of(ptrs)
    _call(lib.zt_match_tokens, "match_tokens", ctypes.byref(args), G, D,
          hist, k, int(lazy), int(min3), *_stream(dev))
    return out
