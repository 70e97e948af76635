"""DEFLATE encoder on the card: the port of zippy_tpu/ops/deflate_device.py.

Every stage is data-parallel tensor work over a group of blocks (the
reference's vmap, written out as a leading group dimension G):

1. `find_tokens` — sort-based match candidates: positions sorted by
   (hash4, pos), the k bucket predecessors are the k most recent previous
   occurrences; match lengths; one-step lazy demotion; the token cover;
   symbol histograms. On a CUDA tensor it is the Hopper kernel K7
   (ops/match_kernels.py, csrc/match.cu), its key sort included;
   `match_kernels.find_tokens_plain`, torch ops with word-window XOR
   compares and a pointer-doubling cover, is its plain version and the CPU
   path.
2. `huffman_tables` (ops/huffman_kernels.py) — length-limited Huffman code
   lengths (`_kraft_lengths`), the exact dynamic-header cost
   (`_header_stats_device`), the stored/fixed/dynamic choice, the
   canonical codes (`_rev_codes_device`) and a dynamic block's header bits
   (`make_dynamic_header`'s). On a CUDA tensor it is one launch
   of the Hopper kernel K5 (csrc/huffman.cu); `huffman_tables_plain`, the
   torch ops here, is its plain version and the CPU path.
3. `pack_tokens` (ops/pack_kernels.py) — each row's codes at their bit
   offsets, the end-of-block code appended. On a CUDA tensor it is one
   launch of the Hopper kernel K8 (csrc/pack.cu), the rows cut into chunks
   that meet by decoupled look-back; `pack_kernels.pack_tokens_plain`,
   per-token bit lengths, their prefix sum and a scatter-add of the
   shifted code words, is its plain version and the CPU path.
4. `join_rows` (ops/join_kernels.py) — each row's 3 block bits, its dynamic
   header's bits and its payload bits (or a stored row's chunks) joined
   into one piece of the stream a group, at the group's start phase. On a
   CUDA tensor it is one launch of the Hopper kernel K10 (csrc/join.cu);
   `join_kernels.join_rows_plain` is its plain version and the CPU path.
   The host fetches each piece's bytes and ORs the byte where two pieces
   meet (`deflate_runs`). `deflate_entries`, whose groups hold many
   streams (their rows gathered on the card from the payloads' tensors),
   joins each stream's run of rows in a group into a piece of its own.
   A run that did not start at stream bit 0 (the multi-card encode) is
   realigned onto the stream on the host (`_append_run`). The host splice
   (`_splice_group`: `_assemble_block` over a `_ByteBitAppender`) runs on
   no encode path; the tests hold the join to it.

Every device stage is a hand-written kernel on a CUDA tensor. The output
bytes are
those of the reference bit for bit, given the same ideal depths
(`_ideal_depth`). Torch has no uint32 arithmetic on the CPU, so 32-bit
words travel as int64 masked to 32 bits, or as int32 bit patterns where
only XOR and bit tests touch them.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import profiling, tables
from ..common import (ZippyError, as_u8_tensor, check_level, host_bytes,
                      payload_tensors, resolve_devices)
from . import huffman_kernels, join_kernels, match_kernels, pack_kernels
from .device_tables import const
# The matcher's constants and word helpers live with K7.
from .match_kernels import EXTW, NRANK, NWIN, PAD

BLOCK = 1 << 16                 # device block size
HIST = 32768                    # cross-block history window (read-only prefix)
_FKEY_MAX = (1 << 20) - 1

# ---------------------------------------------------------------------------
# Phase 1: match finding + token selection + symbol histograms
# ---------------------------------------------------------------------------


def find_tokens(data_pad: torch.Tensor, n, hist_len=0, *, k: int = 4,
                lazy: bool = True, hist: int = 0, min3: bool = False,
                lits_only: bool = False) -> dict:
    """Token cover of a group of blocks.

    data_pad: (G, hist + N + PAD) uint8 — per row an optional read-only
    `hist`-byte prefix (the raw bytes before the block), then the block,
    zero padded past `n`. `n` and `hist_len` (how many prefix bytes are
    real) are per row (or one for every row). Returns a dict of (G, N)
    tensors: is_tok, is_match, length, dist, sym, len_idx, dist_idx; and
    the (G, 286) litlen and (G, 30) dist histograms. On a CUDA tensor the
    kernel K7 (match_kernels.match_tokens) computes them; on a CPU tensor
    its plain version, match_kernels.find_tokens_plain."""
    G, dev = data_pad.shape[0], data_pad.device

    def rows(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev).reshape(
            -1).expand(G).contiguous()

    return match_kernels.match_tokens(
        data_pad.contiguous(), rows(n), rows(hist_len), k=k, lazy=lazy,
        hist=hist, min3=min3, lits_only=lits_only)


# ---------------------------------------------------------------------------
# Phase 2: bit packing with arbitrary code tables
# ---------------------------------------------------------------------------


def pack_tokens(tok: dict, ll_lens: torch.Tensor, ll_codes: torch.Tensor,
                dist_lens: torch.Tensor, dist_codes: torch.Tensor):
    """Serialize each row's token cover to a DEFLATE bit stream (no 3-bit
    block header). Tables are (G, 286) and (G, 30).

    Returns (words (G, N // 2 + 8) int32 holding the uint32 words' bit
    patterns, total_bits (G,)). Bit k of a row's stream is bit (k % 32) of word (k // 32). On a
    CUDA tensor the kernel K8 (pack_kernels.pack_tokens) packs them; on a
    CPU tensor its plain version, pack_kernels.pack_tokens_plain."""
    return pack_kernels.pack_tokens(tok, ll_lens, ll_codes, dist_lens,
                                    dist_codes)


def compress_block_fixed(data_pad: torch.Tensor, n, *, k: int = 4,
                         lazy: bool = True):
    """One block with the fixed Huffman codes: find_tokens, then pack_tokens
    with the fixed tables. `data_pad` is one 1-D uint8 block, zero padded
    past `n` to N + PAD bytes. Returns (words (N // 2 + 8,) int32 holding
    the uint32 words' bit patterns, total_bits, ll_hist (286,), dist_hist
    (30,)) on its device: the payload bits with no 3-bit block header."""
    dev = data_pad.device
    tok = find_tokens(data_pad[None], n, k=k, lazy=lazy)
    words, total_bits = pack_tokens(
        tok, const("fixed_ll", dev)[None], const("fixed_ll_codes", dev)[None],
        const("fixed_d", dev)[None], const("fixed_d_codes", dev)[None])
    return words[0], total_bits[0], tok["ll_hist"][0], tok["dist_hist"][0]


# ---------------------------------------------------------------------------
# Huffman construction on the card
#
# Length-limited code lengths as vector work, Kraft-complete (zlib's
# inflate rejects incomplete litlen codes). See the reference's
# _kraft_lengths for the algorithm; every step after the ideal depths is
# exact IEEE and integer work and matches the reference bit for bit.
# ---------------------------------------------------------------------------


def _ideal_depth(ratio: torch.Tensor) -> torch.Tensor:
    """Ideal code depth -log2(p) = log2(total / freq), float32.

    Computed in float64 and rounded to float32, which gives the same value
    on the CPU and on CUDA; a float32 log2 differs between backends in the
    last ulp, and the depths' ceil/floor turn that ulp into other bytes."""
    return torch.log2(ratio.double()).float()


def _kraft_lengths(freq: torch.Tensor, limit: int) -> torch.Tensor:
    """Valid length-limited canonical-code lengths from (G, S) histograms.
    Guarantees: l = 0 iff freq = 0; 1 <= l <= limit otherwise; Kraft sum
    exactly 1 when >= 2 symbols are active, a single length-1 code when 1
    is. Two depth profiles (water-filled ceil with a bisected offset, and
    nearest rounding) are repaired to Kraft-complete, the cheaper wins, and
    its multiset is reassigned by frequency rank."""
    G, S = freq.shape
    dev = freq.device
    freq = freq.long()
    active = freq > 0
    idx = torch.arange(S, dtype=torch.int64, device=dev)
    total = freq.sum(dim=1, keepdim=True).clamp(min=1)
    nll = _ideal_depth(total.float() / freq.clamp(min=1).float())
    budget = 1 << limit
    fkey = freq.clamp(max=_FKEY_MAX)

    def deficit(l):
        return torch.where(active, 1 << (limit - l), 0).sum(
            dim=1, keepdim=True) - budget

    def lengthen(l):
        # Over-subscribed: lengthen the cheapest (least frequent) symbols.
        need = deficit(l)
        cand = active & (l < limit)
        gain = torch.where(cand, 1 << (limit - l - 1).clamp(min=0), 0)
        order = torch.argsort(torch.where(cand, fkey, 1 << 20) * 512 + idx,
                              dim=1)
        gain_s = gain.gather(1, order)
        sel_s = (torch.cumsum(gain_s, dim=1) - gain_s < need) & (gain_s > 0)
        sel = torch.zeros_like(active).scatter(1, order, sel_s)
        return torch.where(sel & (need > 0), l + 1, l)

    def bulk_shorten(l):
        # Spend the Kraft slack wholesale, best benefit density first.
        slack = -deficit(l)
        cand = active & (l >= 2)
        cost = torch.where(cand, 1 << (limit - l), 0)
        density = torch.where(cand, (freq >> (limit - l)).clamp(max=_FKEY_MAX),
                              -1)
        order = torch.argsort(-(density * 512 - idx), dim=1)
        cost_s = cost.gather(1, order)
        sel_s = (torch.cumsum(cost_s, dim=1) <= slack) & (cost_s > 0)
        sel = torch.zeros_like(active).scatter(1, order, sel_s)
        return torch.where(sel & (slack > 0), l - 1, l)

    def consume(l):
        # Exact completion: shorten the most frequent symbol of the largest
        # cost that still fits (argmax takes the first of tied maxima).
        slack = -deficit(l)
        cand = active & (l >= 2)
        cost = torch.where(cand, 1 << (limit - l), 1 << 28)
        fits = cost <= slack
        maxcost = torch.where(fits, cost, -1).amax(dim=1, keepdim=True)
        pick = torch.where(fits & (cost == maxcost), freq, -1).argmax(
            dim=1, keepdim=True)
        do = (slack > 0) & fits.any(dim=1, keepdim=True)
        return l.scatter_add(1, pick, torch.where(do, -1, 0))

    def refine(lens0):
        l = torch.where(active, lens0.clamp(1, limit), 0)
        for _ in range(limit):
            l = lengthen(l)
        for _ in range(limit):
            l = bulk_shorten(l)
        for _ in range(2 * limit + 4):
            l = consume(l)
        return l

    # Candidate (a): water-filled ceil with a bisected offset t.
    def ksum(t):
        l = torch.clamp(torch.ceil(nll + t), 1, limit).long()
        return torch.where(active, 1 << (limit - l), 0).sum(dim=1,
                                                            keepdim=True)

    lo = torch.full((G, 1), -float(limit), dtype=torch.float32, device=dev)
    hi = torch.full((G, 1), float(limit), dtype=torch.float32, device=dev)
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        ok = ksum(mid) <= budget
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    lens_a = refine(torch.ceil(nll + hi).long())
    # Candidate (b): nearest rounding (dyadic-exact).
    lens_b = refine(torch.floor(nll + 0.5).long())

    bits_a = (freq * lens_a).sum(dim=1, keepdim=True)
    bits_b = (freq * lens_b).sum(dim=1, keepdim=True)
    lens = torch.where(bits_a <= bits_b, lens_a, lens_b)

    # Reassign the winning multiset by frequency rank.
    lens_asc = torch.sort(torch.where(active, lens, 99), dim=1).values
    order_f = torch.argsort(((1 << 20) - fkey) * 512 + idx, dim=1)
    rank = torch.zeros_like(order_f).scatter(1, order_f, idx.expand(G, S))
    return torch.where(active, lens_asc.gather(1, rank), 0)


def _rev15(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 15 bits (reverse 16, shift right one)."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def _canonical_device(lens: torch.Tensor) -> torch.Tensor:
    """Canonical MSB-first codes (RFC 1951 3.2.2) for (G, S) code lengths."""
    oh = (lens.unsqueeze(2) == torch.arange(16, device=lens.device)).long()
    count = oh.sum(dim=1)                                      # (G, 16)
    zero = torch.zeros_like(count[:, 0])
    firsts = [zero, zero]            # first_code for lengths 0, 1
    for bits in range(2, 16):
        firsts.append((firsts[bits - 1] + count[:, bits - 1]) << 1)
    first = torch.stack(firsts, dim=1)                         # (G, 16)
    rank = torch.cumsum(oh, dim=1) - oh
    rank_s = rank.gather(2, lens.unsqueeze(2)).squeeze(2)
    return first.gather(1, lens) + rank_s


def _rev_codes_device(lens: torch.Tensor) -> torch.Tensor:
    """Canonical codes, bit-reversed for LSB-first emission."""
    rev = _rev15(_canonical_device(lens)) >> (15 - lens).clamp(min=0)
    return torch.where(lens > 0, rev, 0)


def _header_stats_device(ll_lens: torch.Tensor, d_lens: torch.Tensor):
    """EXACT dynamic-header cost + code-length-code lengths per row.

    The host RLE greedy (_rle_code_lengths) in closed form per run. Returns
    (header_bits, cl_lens, hlit, hdist); the host emitter reuses cl_lens so
    the emitted header is the size costed here."""
    G = ll_lens.shape[0]
    dev = ll_lens.device
    i64 = torch.int64
    last_ll = torch.where(ll_lens > 0, torch.arange(286, device=dev),
                          -1).amax(dim=1)
    hlit = (last_ll + 1).clamp(min=257).unsqueeze(1)
    last_d = torch.where(d_lens > 0, torch.arange(30, device=dev),
                         -1).amax(dim=1)
    hdist = (last_d + 1).clamp(min=1).unsqueeze(1)
    total = hlit + hdist

    j = torch.arange(316, dtype=i64, device=dev).expand(G, 316)
    vals = torch.where(j < hlit, ll_lens.gather(1, j.clamp(0, 285)),
                       d_lens.gather(1, (j - hlit).clamp(0, 29)))
    vals = torch.where(j < total, vals, -1)
    prev = torch.cat([torch.full((G, 1), -2, dtype=i64, device=dev),
                      vals[:, :-1]], dim=1)
    is_start = vals != prev
    run_id = torch.cumsum(is_start.long(), dim=1) - 1
    run_len = torch.zeros(G, 316, dtype=i64, device=dev).scatter_add_(
        1, run_id, torch.ones_like(run_id))
    run_val = torch.zeros(G, 316, dtype=i64, device=dev).scatter_add_(
        1, run_id, torch.where(is_start, vals, 0))
    valid = (run_len > 0) & (run_val >= 0)

    r = run_len
    # v == 0 runs: 138-cap greedy.
    z = valid & (run_val == 0)
    q138, s138 = r // 138, r % 138
    n18 = torch.where(z, q138 + (s138 > 10).long(), 0)
    n17 = torch.where(z & (s138 >= 3) & (s138 <= 10), 1, 0)
    sing0 = torch.where(z & (s138 < 3), s138, 0)
    # v > 0 runs: leading literal + 6-cap sym16 greedy over r-1.
    pv = valid & (run_val > 0)
    r1 = (r - 1).clamp(min=0)
    q6, s6 = r1 // 6, r1 % 6
    n16 = torch.where(pv, q6 + (s6 >= 3).long(), 0)
    singv = torch.where(pv, 1 + torch.where(s6 < 3, s6, 0), 0)

    cl_freq = torch.zeros(G, 19, dtype=i64, device=dev).scatter_add_(
        1, run_val.clamp(0, 15), sing0 + singv)
    cl_freq[:, 16] += n16.sum(dim=1)
    cl_freq[:, 17] += n17.sum(dim=1)
    cl_freq[:, 18] += n18.sum(dim=1)
    cl_lens = _kraft_lengths(cl_freq, 7)

    ord_lens = cl_lens[:, const("clcl_order", dev)]
    last_o = torch.where(ord_lens > 0, torch.arange(19, device=dev),
                         -1).amax(dim=1)
    hclen = (last_o + 1).clamp(min=4)
    emis_bits = ((cl_freq * cl_lens).sum(dim=1)
                 + (cl_freq * const("cl_extra", dev)).sum(dim=1))
    header_bits = 14 + 3 * hclen + emis_bits
    return header_bits, cl_lens, hlit.squeeze(1), hdist.squeeze(1)


def huffman_tables_plain(ll_hist: torch.Tensor, dist_hist: torch.Tensor,
                         n: torch.Tensor) -> dict:
    """Plain version of K5 (huffman_kernels.huffman_tables), the torch ops
    of the reference's encode_block between find_tokens and pack_tokens:
    the three Kraft builds, the exact header cost, the mode choice and the
    codes of the chosen tables, for (G, 286) and (G, 30) histograms and the
    (G,) byte counts; and each dynamic row's header bits, from
    make_dynamic_header. Returns huffman_kernels.huffman_tables' dict."""
    dev = ll_hist.device
    ll_lens = _kraft_lengths(ll_hist, 15)
    d_lens = _kraft_lengths(dist_hist, 15)
    header_bits, cl_lens, _, _ = _header_stats_device(ll_lens, d_lens)

    extra = ((ll_hist[:, 257:286] * const("len_extra", dev)).sum(dim=1)
             + (dist_hist * const("dist_extra", dev)).sum(dim=1))
    fixed_ll, fixed_d = const("fixed_ll", dev), const("fixed_d", dev)
    dyn_bits = (3 + header_bits + (ll_hist * ll_lens).sum(dim=1)
                + (dist_hist * d_lens).sum(dim=1) + extra)
    fix_bits = (3 + (ll_hist * fixed_ll).sum(dim=1)
                + (dist_hist * fixed_d).sum(dim=1) + extra)
    stored_bits = 8 * (n + 5 * ((n + 0xFFFE) // 0xFFFF)) + 7
    mode = torch.where(stored_bits < torch.minimum(dyn_bits, fix_bits), 0,
                       torch.where(fix_bits <= dyn_bits, 1, 2))
    hdr_bits, hdr_words = _dynamic_headers(mode, ll_lens, d_lens, cl_lens)
    dyn = (mode == 2).unsqueeze(1)
    # Fixed-mode codes come from the precomputed 288-symbol table (symbols
    # 286/287 shift the canonical codes of 280-285).
    return {
        "ll_lens": ll_lens,
        "d_lens": d_lens,
        "cl_lens": cl_lens,
        "mode": mode,
        "use_ll": torch.where(dyn, ll_lens, fixed_ll),
        "ll_codes": torch.where(dyn, _rev_codes_device(ll_lens),
                                const("fixed_ll_codes", dev)),
        "use_d": torch.where(dyn, d_lens, fixed_d),
        "d_codes": torch.where(dyn, _rev_codes_device(d_lens),
                               const("fixed_d_codes", dev)),
        "hdr_bits": hdr_bits,
        "hdr_words": hdr_words,
    }


def _dynamic_headers(mode: torch.Tensor, ll_lens: torch.Tensor,
                     d_lens: torch.Tensor, cl_lens: torch.Tensor):
    """huffman_tables' hdr_bits (G,) int64 and hdr_words (G, HDR_WORDS)
    int32: each dynamic row's make_dynamic_header bits, zeros elsewhere."""
    bits = np.zeros(mode.shape[0], np.int64)
    words = np.zeros((mode.shape[0], huffman_kernels.HDR_WORDS), np.int32)
    lens = [t.cpu().numpy() for t in (ll_lens, d_lens, cl_lens)]
    for j in np.flatnonzero(mode.cpu().numpy() == 2):
        header, bits[j] = make_dynamic_header(*(t[j] for t in lens))
        words[j].view(np.uint8)[:len(header)] = np.frombuffer(header,
                                                              np.uint8)
    return (torch.from_numpy(bits).to(mode.device),
            torch.from_numpy(words).to(mode.device))


def _encode_group(blocks: torch.Tensor, lens: torch.Tensor,
                  hist_lens: torch.Tensor, *, k: int, lazy: bool, hist: int,
                  min3: bool = False, lits_only: bool = False,
                  stages: dict | None = None) -> dict:
    """The full encode of a group of blocks: match finding, token
    selection, the Huffman tables and the exact stored/fixed/dynamic
    choice (`huffman_kernels.huffman_tables`: K5 on a CUDA tensor), and bit
    packing with the chosen table. Returns a dict of (G, ...) tensors:
    words, nbits, mode (0 stored / 1 fixed / 2 dynamic), ll_lens[286],
    d_lens[30], cl_lens[19], and a dynamic row's header, hdr_bits long in
    hdr_words[HDR_WORDS] (as huffman_kernels.huffman_tables gives them).
    `stages`, a dict, gets the synchronized seconds of find_tokens, kraft
    and pack (profiling.span)."""
    dev = blocks.device
    n = lens.long()
    with profiling.span("find_tokens", stages, dev):
        tok = find_tokens(blocks, n, hist_lens, k=k, lazy=lazy, hist=hist,
                          min3=min3, lits_only=lits_only)
    with profiling.span("kraft", stages, dev):
        tab = huffman_kernels.huffman_tables(tok["ll_hist"],
                                             tok["dist_hist"], n)
    with profiling.span("pack", stages, dev):
        words, nbits = pack_tokens(tok, tab["use_ll"], tab["ll_codes"],
                                   tab["use_d"], tab["d_codes"])
    return {
        "words": words,
        "nbits": nbits,
        "mode": tab["mode"],
        "ll_lens": tab["ll_lens"],
        "d_lens": tab["d_lens"],
        "cl_lens": tab["cl_lens"],
        "hdr_bits": tab["hdr_bits"],
        "hdr_words": tab["hdr_words"],
    }


def encode_block(data_pad: torch.Tensor, n, hist_len=0, *, k: int = 4,
                 lazy: bool = True, hist: int = 0, min3: bool = False,
                 lits_only: bool = False) -> dict:
    """The full encode of one block, as one row of _encode_group: `data_pad`
    is a 1-D row laid out as find_tokens' rows are. Returns the reference's
    dict, _encode_group's with the group axis dropped and without the
    header words, which only the splice reads."""
    dev = data_pad.device
    res = _encode_group(
        data_pad[None], torch.as_tensor(n, device=dev).reshape(1),
        torch.as_tensor(hist_len, device=dev).reshape(1), k=k, lazy=lazy,
        hist=hist, min3=min3, lits_only=lits_only)
    return {key: v[0] for key, v in res.items()
            if key not in ("hdr_bits", "hdr_words")}


# ---------------------------------------------------------------------------
# Host orchestration: the dynamic Huffman header (the reference's API and
# the plain version's; the encoder splices K5's) + stream assembly
# ---------------------------------------------------------------------------


class _HostBitWriter:
    """Small LSB-first bit writer for block headers (host side only)."""

    def __init__(self):
        self.out = bytearray()
        self.bitbuf = 0
        self.bitcnt = 0

    def add(self, value: int, nbits: int) -> None:
        self.bitbuf |= (value & ((1 << nbits) - 1)) << self.bitcnt
        self.bitcnt += nbits
        while self.bitcnt >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcnt -= 8

    def bit_length(self) -> int:
        return len(self.out) * 8 + self.bitcnt


def build_code_lengths(freq: np.ndarray, limit: int) -> np.ndarray:
    """Optimal length-limited Huffman code lengths by package-merge, on the
    host: l = 0 iff freq = 0, a lone active symbol gets length 1. Kept for
    parity with the reference's API (make_dynamic_header with no cl_lens):
    no device path runs it, the encoder builds its lengths on the card
    (_kraft_lengths)."""
    n = len(freq)
    lens = np.zeros(n, dtype=np.int32)
    active = np.nonzero(freq)[0]
    if len(active) == 0:
        return lens
    if len(active) == 1:
        lens[active[0]] = 1
        return lens
    # Leaves are ~symbol (negative), packages their index in `arena`; ties
    # in weight sort leaves by ~symbol, as the reference does.
    leaves = sorted((int(freq[s]), ~int(s)) for s in active)
    arena: list[tuple[int, int]] = []
    merged = list(leaves)
    for _ in range(1, limit):
        packages = []
        for i in range(0, len(merged) - 1, 2):
            arena.append((merged[i][1], merged[i + 1][1]))
            packages.append((merged[i][0] + merged[i + 1][0], len(arena) - 1))
        out, a, b = [], 0, 0
        while a < len(leaves) or b < len(packages):
            if b >= len(packages) or (a < len(leaves)
                                      and leaves[a][0] <= packages[b][0]):
                out.append(leaves[a])
                a += 1
            else:
                out.append(packages[b])
                b += 1
        merged = out
    # Each of the first 2(n - 1) items adds one to the length of every
    # leaf it holds.
    stack = []
    for i in range(min(2 * (len(active) - 1), len(merged))):
        stack.append(merged[i][1])
        while stack:
            it = stack.pop()
            if it < 0:
                lens[~it] += 1
            else:
                stack.extend(arena[it])
    return lens


def _rle_code_lengths(lens: np.ndarray) -> list[tuple[int, int, int]]:
    """RFC 1951 3.2.7 run-length coding of the code-length sequence, as
    (sym, extra_val, extra_bits)."""
    out = []
    i, n = 0, len(lens)
    while i < n:
        v = int(lens[i])
        run = 1
        while i + run < n and lens[i + run] == v:
            run += 1
        if v == 0:
            r = run
            while r >= 3:
                take = min(r, 138)
                out.append((18, take - 11, 7) if take > 10
                           else (17, take - 3, 3))
                r -= take
            out.extend([(0, 0, 0)] * r)
        else:
            out.append((v, 0, 0))
            r = run - 1
            while r >= 3:
                take = min(r, 6)
                out.append((16, take - 3, 2))
                r -= take
            out.extend([(v, 0, 0)] * r)
        i += run
    return out


def make_dynamic_header(ll_lens: np.ndarray, dist_lens: np.ndarray,
                        cl_lens: np.ndarray | None = None):
    """Dynamic block header bits (HLIT/HDIST/HCLEN + CL-coded lengths).
    Returns (header_bytes, header_bit_length). `cl_lens`, when given, are
    the device-built code-length-code lengths, used verbatim so the header
    is the size the device costed; None builds them on the host
    (build_code_lengths, limit 7)."""
    hlit = 286
    while hlit > 257 and ll_lens[hlit - 1] == 0:
        hlit -= 1
    hdist = 30
    while hdist > 1 and dist_lens[hdist - 1] == 0:
        hdist -= 1
    all_lens = np.concatenate([ll_lens[:hlit], dist_lens[:hdist]])
    rle = _rle_code_lengths(all_lens)
    if cl_lens is None:
        cl_lens = build_code_lengths(
            np.bincount([sym for sym, _, _ in rle], minlength=19), 7)
    cl_codes = tables.canonical_codes(cl_lens)
    order = tables.CLCL_ORDER
    hclen = 19
    while hclen > 4 and cl_lens[order[hclen - 1]] == 0:
        hclen -= 1
    bw = _HostBitWriter()
    bw.add(hlit - 257, 5)
    bw.add(hdist - 1, 5)
    bw.add(hclen - 4, 4)
    for i in range(hclen):
        bw.add(int(cl_lens[order[i]]), 3)
    for sym_v, extra_val, extra_bits in rle:
        bw.add(int(cl_codes[sym_v]), int(cl_lens[sym_v]))
        if extra_bits:
            bw.add(extra_val, extra_bits)
    return bytes(bw.out) + bytes([bw.bitbuf & 0xFF]), bw.bit_length()


class _ByteBitAppender:
    """Append bit strings (given as LSB-first byte arrays) efficiently."""

    def __init__(self):
        self.out = bytearray()
        self.bitpos = 0  # bits valid in self.out

    def append_bits(self, payload: np.ndarray, nbits: int) -> None:
        if nbits == 0:
            return
        sh = self.bitpos & 7
        data = payload[: (nbits + 7) // 8].astype(np.uint16)
        if sh == 0:
            self.out += data.astype(np.uint8).tobytes()
        else:
            shifted = (data << sh) & 0xFF
            carry = (data >> (8 - sh)).astype(np.uint8)
            lead = self.out[-1] | int(shifted[0])
            body = (shifted[1:].astype(np.uint8) | carry[:-1])
            self.out[-1] = lead
            self.out += body.tobytes()
            self.out.append(int(carry[-1]))
        self.bitpos += nbits
        # Trim bytes beyond the bit position.
        del self.out[(self.bitpos + 7) // 8:]

    def append_host_writer(self, bw: _HostBitWriter) -> None:
        buf = np.frombuffer(bytes(bw.out) + bytes([bw.bitbuf & 0xFF]),
                            dtype=np.uint8)
        self.append_bits(buf, bw.bit_length())


_MODES = ("stored", "fixed", "dynamic")


def _assemble_block(out: _ByteBitAppender, mode_i: int, hdr_bits: int,
                    hdr: np.ndarray, words_row: np.ndarray, nbits: int,
                    raw, blen: int, final: bool, lap=None) -> None:
    """Splice one device-encoded block: a dynamic block's header from its
    fetched header bytes (`hdr_bits` bits of `hdr`), payload from the
    packed words. `lap` (profiling.laps) times the header apart from the
    append."""
    mode = _MODES[mode_i]
    header_info = None
    if mode == "dynamic":
        header_info = (hdr, hdr_bits)
        if lap:
            lap("splice.header")
    _append_block(out, mode, header_info, words_row, nbits, raw, blen, final)
    if lap:
        lap("splice.append")


def _append_block(out: _ByteBitAppender, mode: str, header_info,
                  words_row: np.ndarray | None, nbits: int,
                  raw: np.ndarray | None, blen: int, final: bool) -> None:
    """Splice one block (header + payload) onto the stream; a dynamic
    block's header_info is (its header's LSB-first bytes, their bits)."""
    if mode == "stored":
        off = 0
        while off < blen:
            chunk = min(blen - off, 0xFFFF)
            last = off + chunk == blen
            bw = _HostBitWriter()
            bw.add(1 if (final and last) else 0, 1)
            bw.add(0, 2)
            # LEN must start on a GLOBAL byte boundary.
            pad = (-(out.bitpos + 3)) % 8
            if pad:
                bw.add(0, pad)
            bw.add(chunk, 16)
            bw.add(chunk ^ 0xFFFF, 16)
            out.append_host_writer(bw)
            out.append_bits(raw[off:off + chunk], chunk * 8)
            off += chunk
        return
    bw = _HostBitWriter()
    bw.add(1 if final else 0, 1)
    bw.add(1 if mode == "fixed" else 2, 2)
    out.append_host_writer(bw)
    if mode == "dynamic":
        out.append_bits(*header_info)
    if nbits:
        out.append_bits(words_row.view(np.uint8), nbits)


def _empty_stream() -> bytes:
    """A final fixed-Huffman block holding only end-of-block (7 zero bits):
    the bytes every level of the reference's host codec writes for b""."""
    out = _ByteBitAppender()
    _append_block(out, "fixed", None, None, 0, None, 0, True)
    out.append_bits(np.zeros(1, np.uint8), 7)
    return bytes(out.out)


def _level_params(level: int) -> tuple[int, bool, bool]:
    """(k candidates, lazy, min3) per level: k candidates = the k most
    recent same-hash positions (a depth-k chain walk); min3 adds length-3
    short-distance matches at the quality tiers."""
    if level == -1:
        level = 6  # DefaultCompression maps to the level-6 row
    if level <= 3:
        return 2, False, False
    if level <= 5:
        return 4, True, False
    if level == 6:
        return 12, True, False
    if level <= 8:
        return 16, True, True
    return 32, True, True


MIN_BLOCK = 256

# Memory for one group's matcher intermediates in the plain version: the
# largest are the (G, N, k, 8) ranking windows and their XOR and mask
# copies; 12 bytes per gathered word and position covers them. K7 holds no
# windows and needs far less (PERF.md, section 7), but the group sizes stay
# these. The group size decides no bytes.
GROUP_BYTES = 8 << 30
MAX_GROUP = 64


def _group_size(k: int, block_size: int) -> int:
    words = k * (NRANK if k >= 4 else NWIN) + 3 * NWIN + EXTW
    return max(1, min(MAX_GROUP, GROUP_BYTES // (block_size * words * 12)))


def deflate_array(x: torch.Tensor, level: int, block_size: int = BLOCK, *,
                  stages: dict | None = None,
                  matcher: int | None = None) -> bytes:
    """Raw DEFLATE stream from a 1-D uint8 tensor, encoded on its device.

    Block rows are sliced on the device; only the per-block code lengths,
    modes and packed words (the output itself) come back. Stored-mode
    blocks fetch just their own raw bytes. Level 0 (stored framing) fetches
    the input once, since its output is the input. Level -1 runs level 1's
    matcher here, as zippy_tpu's deflate_array does (`deflate` of host
    bytes runs level 6's); `matcher`, if given, is the level whose matcher
    runs instead (a caller that uploaded host bytes passes `level`).
    `stages`, a dict, gets each stage's wall seconds, the card synchronized
    before and after each (profiling.span): find_tokens, kraft and pack a
    group, fetch, splice."""
    if (not isinstance(x, torch.Tensor) or x.dtype != torch.uint8
            or x.dim() != 1):
        raise ZippyError("deflate_array expects a 1-D uint8 tensor")
    check_level(level)
    return deflate_runs(x, level, max(level, 1) if matcher is None
                        else matcher, block_size, [x.device], stages)


def _encode_run(buf: torch.Tensor, b0: int, nrows: int, n: int,
                block_size: int, hist: int, params: dict, last: int,
                stages: dict | None = None):
    """Encode blocks b0 .. b0 + nrows - 1 of an n-byte payload on buf's
    device, a group of _group_size blocks at a time, and join each group's
    rows into a piece of the run's stream (join_kernels.join_rows), the
    run's first group at bit 0. `buf` holds their rows: from `hist` bytes
    before block b0 (zeros before the payload) to PAD bytes past the last
    block (zeros past the payload); `last` is the payload's last block. A
    generator: each step issues one group and its join, with no host sync,
    and yields (the piece, the run's state rows of the group's start and of
    its join) unfetched. A group's encode results are freed once its join
    is issued."""
    gmax = _group_size(params["k"], block_size)
    state = join_kernels.new_state(-(-nrows // gmax), buf.device)
    for gi, i in enumerate(range(0, nrows, gmax)):
        g = min(gmax, nrows - i)
        with profiling.span("encode.issue"):
            blocks, lens, hist_lens = _group_inputs(buf, b0, i, g, n,
                                                    block_size, hist)
            res = _encode_group(blocks, lens, hist_lens, hist=hist,
                                stages=stages, **params)
            with profiling.span("join", stages, buf.device):
                piece = join_kernels.join_rows(
                    res, lens, blocks, hist, block_size,
                    last - b0 - i if last < b0 + i + g else -1, state, gi)
        profiling.count("join.rows", g)
        del blocks, lens, hist_lens, res
        yield piece, state[gi:gi + 2]


def _group_inputs(buf: torch.Tensor, b0: int, i: int, g: int, n: int,
                  block_size: int, hist: int):
    """_encode_group's (blocks, lens, hist_lens) for blocks b0 + i ..
    b0 + i + g - 1 of an n-byte payload, from buf, a run's rows as
    _encode_run takes them."""
    rows = buf.unfold(0, hist + block_size + PAD, block_size)
    starts = torch.arange(b0 + i, b0 + i + g, dtype=torch.int64,
                          device=buf.device) * block_size
    return (rows[i:i + g].contiguous(), (n - starts).clamp(max=block_size),
            starts.clamp(max=hist))


def _run_buffer(x: torch.Tensor, b0: int, b1: int, block_size: int,
                hist: int, device: torch.device) -> torch.Tensor:
    """The rows of blocks b0 .. b1 - 1 of x (a 1-D uint8 tensor) for
    _encode_run, on `device`: from `hist` bytes before block b0 to PAD
    bytes past block b1 - 1, zeros outside the payload."""
    n = int(x.shape[0])
    lo = b0 * block_size - hist        # may lie before the payload
    src = x[max(lo, 0):min(b1 * block_size + PAD, n)]
    buf = torch.zeros(hist + (b1 - b0) * block_size + PAD,
                      dtype=torch.uint8, device=device)
    buf[max(lo, 0) - lo:max(lo, 0) - lo + len(src)] = src
    if src.device != buf.device:
        profiling.count("upload.bytes", src.nbytes)
    return buf


def deflate_runs(x: torch.Tensor, level: int, matcher_level: int,
                 block_size: int, devices: list[torch.device],
                 stages: dict | None = None) -> bytes:
    """The stream of `deflate_array`, `deflate` and
    parallel.deflate_sharded. The blocks of `x` (a 1-D uint8 tensor on any
    device) go to `devices` in contiguous runs, one a device (a device may
    repeat); each run gets one copy of its bytes, with the HIST bytes before
    it and PAD after it, on its device. Every run's next group is issued,
    with its join, before any is fetched, and the host fetches only each
    group's piece of the stream (_fetch_piece). The first run's pieces join
    into the stream by an OR of the byte where two pieces meet; each later
    run, joined on its device as if it started at stream bit 0, is
    realigned onto the stream (_append_run), so the stream is the same at
    every device count. `level` sets the block format (0 stored, -2
    literals only), `matcher_level` the matcher; `stages` (one device) gets
    each stage's wall seconds."""
    if not MIN_BLOCK <= block_size <= (1 << 17) - HIST:
        raise ZippyError(f"block_size must lie in [{MIN_BLOCK}, "
                         f"{(1 << 17) - HIST}]")
    n = int(x.shape[0])
    if n == 0:
        return _empty_stream()
    if level == 0:
        out = _ByteBitAppender()
        _append_block(out, "stored", None, None, 0, x.cpu().numpy(), n, True)
        return bytes(out.out)
    lits_only = level == -2
    k, lazy, min3 = _level_params(1 if lits_only else matcher_level)
    params = {"k": k, "lazy": lazy, "min3": min3, "lits_only": lits_only}
    nblocks = -(-n // block_size)
    hist = HIST if nblocks > 1 else 0
    bounds = [nblocks * i // len(devices) for i in range(len(devices) + 1)]
    runs = []
    for dev, b0, b1 in zip(devices, bounds, bounds[1:]):
        if b0 == b1:
            continue
        with profiling.span("encode.issue"):
            buf = _run_buffer(x, b0, b1, block_size, hist, dev)
        runs.append(_encode_run(buf, b0, b1 - b0, n, block_size, hist,
                                params, nblocks - 1, stages))
    pieces: list = [[] for _ in runs]
    for issued in itertools.zip_longest(*runs):
        for run, joined in zip(pieces, issued):
            if joined is not None:
                with profiling.span("fetch", stages, devices[0]):
                    run.append(_fetch_piece(*joined))
        # The fetched groups' pieces go before the next groups are issued.
        del issued, joined
    if len(pieces) == 1:
        views, _, _ = _join_pieces(pieces[0])
        with profiling.span("framing"):
            stream = b"".join(views)
    else:
        out = _ByteBitAppender()
        with profiling.span("splice", stages, devices[0]):
            for run in pieces:
                views, bits, cut = _join_pieces(run)
                _append_run(out, np.frombuffer(b"".join(views), np.uint8),
                            bits, cut)
        with profiling.span("framing"):
            stream = bytes(out.out)
    profiling.count("fetch.used_bytes", len(stream))
    return stream


def _copy_to_host(t: torch.Tensor) -> np.ndarray:
    """`t` as a numpy array: a CPU tensor's own memory; a CUDA tensor
    copied to pinned memory on its device's stream, after what that
    stream holds, the host waiting for an event behind the copy."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    with profiling.span("encode.wait"):
        event.synchronize()
    return host.numpy()


def _fetch_piece(piece: torch.Tensor, state: torch.Tensor) -> tuple:
    """Wait for a group's join (join_kernels.join_rows: its `piece` and its
    run's state rows of the group's start and of its join, as _encode_run
    yields them) and copy exactly its piece's bytes to the host. Returns
    (the group's start phase, its bits, its cut, the piece's bytes as a
    numpy uint8 array); ZippyError for a group the join refused."""
    head = _copy_to_host(state)
    phase = int(head[0, join_kernels.PHASE])
    _, bits, cut, err = head[1].tolist()
    _check_join(err)
    nbytes = (phase + bits + 7) // 8
    profiling.count("fetch.bytes", head.nbytes + nbytes)
    return phase, bits, cut, _copy_to_host(piece[:nbytes])


def _check_join(err: int) -> None:
    """ZippyError for a join's error word (join_kernels.ERRORS) that is not
    0."""
    if err:
        raise ZippyError("the stream join refused a group: " + "; ".join(
            why for bit, why in join_kernels.ERRORS.items() if err & bit))


def _join_pieces(pieces: list) -> tuple[list, int, int]:
    """A run's fetched pieces (_fetch_piece's, in order) as (byte views
    that b"".join joins into the run's stream, its bits, its cut: the bit
    just past the block bits of its first stored block with a byte, -1 for
    none). Each piece's first byte takes the previous piece's last bits,
    ORed in place, and the previous view drops that byte."""
    views, bits, cut = [], 0, -1
    for phase, nbits, piece_cut, data in pieces:
        if cut < 0 and piece_cut >= 0:
            cut = bits - phase + piece_cut
        if phase:
            data[0] |= views[-1][-1]
            views[-1] = views[-1][:-1]
        views.append(data)
        bits += nbits
    return views, bits, cut


def _append_run(out: _ByteBitAppender, data: np.ndarray, bits: int,
                cut: int) -> None:
    """Append a run's stream, joined as if it started at stream bit 0
    (`bits` bits of `data`; `cut` as _join_pieces gives it), at out's bit
    position. Its blocks before that first stored block take the same bits
    at any start; the stored block's LEN, and all after it, start on a
    byte boundary in both placements, so from there on its bytes are
    copied as they are."""
    if cut < 0 or out.bitpos % 8 == 0:
        out.append_bits(data, bits)
        return
    out.append_bits(data, cut)
    out.bitpos = -(-out.bitpos // 8) * 8
    aligned = -(-cut // 8) * 8
    out.append_bits(data[aligned // 8:], bits - aligned)


def _start_fetch(res: dict):
    """Enqueue the copy of an issued group's results to the host, with no
    host sync: per row the mode, the payload bits, the header bits and the
    header words (meta, int64: the HDR_WORDS int32 words two a column), and
    the packed words. On a card the copies go to pinned memory on the
    results' device's stream, followed by an event. Returns what
    _finish_fetch takes (deflate_entries' fetch)."""
    meta = torch.cat([res["mode"][:, None], res["nbits"][:, None],
                      res["hdr_bits"][:, None],
                      res["hdr_words"].view(torch.int64)], dim=1)
    words = res["words"]        # int32 bit patterns, as pack_tokens wrote
    profiling.count("fetch.bytes", meta.nbytes + words.nbytes)
    if meta.device.type != "cuda":
        return meta, words, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            .copy_(t, non_blocking=True) for t in (meta, words)]
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(meta.device))
    return (*host, event)


def _finish_fetch(fetch) -> tuple[np.ndarray, np.ndarray]:
    """Wait for a group's copies (_start_fetch): (meta, the packed words up
    to the longest row's) as numpy arrays."""
    meta, words, event = fetch
    if event is not None:
        with profiling.span("encode.wait"):
            event.synchronize()
    meta = meta.numpy()
    if profiling.enabled():
        profiling.count("fetch.used_bytes", int(((meta[:, 1] + 7) // 8).sum()))
    nwords = max(1, -(-int(meta[:, 1].max()) // 32))
    if nwords > words.shape[1]:
        # Only tokens that are no cover could cost more bits than a row's
        # words hold (pack_kernels.words_per_row).
        raise ZippyError(f"a block's {int(meta[:, 1].max())} bits overflow "
                         f"its {words.shape[1]} packed words")
    return meta, words.numpy()[:, :nwords].view("<u4")


def _splice_group(meta: np.ndarray, words: np.ndarray, blocks: list,
                  raw) -> None:
    """Splice a fetched group's rows onto their streams: blocks[j] = (the
    stream's _ByteBitAppender, the block's length, whether it is the
    stream's last block) for row j; raw(j) gives row j's input bytes, read
    only for a stored block."""
    lap = profiling.laps()
    modes, nbits, hdr_bits = meta[:, :3].T.tolist()
    hdr = meta[:, 3:].view(np.uint8)    # each row's header words, as bytes
    for j, (out, blen, final) in enumerate(blocks):
        _assemble_block(out, modes[j], hdr_bits[j], hdr[j], words[j],
                        nbits[j], raw(j) if modes[j] == 0 else None, blen,
                        final, lap)
    if lap:
        lap.close()
        profiling.count("splice.header_rows", modes.count(2))


def _entry_rows(payloads: list, block_size: int, hist: int):
    """The rows of every block of every payload whose stream takes `hist`
    (HIST for payloads of more than one block, 0 for one block), in
    payload order: (payload index, block start, block length, last)."""
    for p, data in enumerate(payloads):
        n = len(data)
        nblocks = -(-n // block_size)
        if n == 0 or (nblocks > 1) != (hist > 0):
            continue
        for b in range(nblocks):
            s = b * block_size
            yield p, s, min(block_size, n - s), b == nblocks - 1


# The encode results join_rows reads, row for row.
_JOINED = ("mode", "nbits", "hdr_bits", "hdr_words", "words")


def _issue_entry_group(payloads: list, rows: list, block_size: int,
                       hist: int, params: dict, dev: torch.device,
                       keep: list, carry: torch.Tensor | None):
    """Issue one group of deflate_entries with no host sync, and the copy
    of its results to the host.

    The group's rows are built on the card from the payload tensors, as
    deflate_runs' buffer lays them out (the `hist` bytes before the block,
    zeros before the payload; the block; PAD bytes after it, zeros past the
    payload): each payload's run of rows in the group is a _run_buffer,
    whose overlapping windows are gathered into the group's rows. Only the
    rows' lengths are uploaded (from pinned memory for CUDA, appended to
    `keep` until the next sync). After the encode, each run is joined into
    one piece of its payload's stream (join_kernels.join_rows, one launch a
    run) in a state of two rows a run: the first run starts where `carry`,
    the state row the group before left, says when it continues a stream;
    every other run starts a stream at bit 0. The state and the pieces go
    to the host in one copy. Returns (the runs, each (payload, its rows),
    the state row the next group continues from, what
    _finish_entry_group takes)."""
    width = hist + block_size + PAD
    runs, parts = [], []
    for p, run in itertools.groupby(rows, key=lambda row: row[0]):
        run = list(run)
        b0 = run[0][1] // block_size
        buf = _run_buffer(payloads[p], b0, b0 + len(run), block_size, hist,
                          dev)
        parts.append(buf.unfold(0, width, block_size))
        runs.append((p, run))
    blocks = torch.cat(parts)
    lens = torch.tensor([[blen for _, _, blen, _ in rows],
                         [min(s, hist) for _, s, _, _ in rows]],
                        dtype=torch.int64)
    profiling.count("upload.bytes", lens.nbytes)
    if dev.type == "cuda":
        lens = lens.pin_memory()
        keep.append(lens)
    lens = lens.to(dev, non_blocking=True)
    res = _encode_group(blocks, lens[0], lens[1], hist=hist, **params)
    state = join_kernels.new_state(2 * len(runs) - 1, dev)
    if rows[0][1]:
        state[0] = carry
    out, j = [state.view(torch.uint8).view(-1)], 0
    with profiling.span("join"):
        for t, (_, run) in enumerate(runs):
            g = len(run)
            out.append(join_kernels.join_rows(
                {key: res[key][j:j + g] for key in _JOINED},
                lens[0][j:j + g], blocks[j:j + g], hist, block_size,
                g - 1 if run[-1][3] else -1, state, 2 * t))
            j += g
    profiling.count("join.rows", len(rows))
    out = torch.cat(out)
    profiling.count("fetch.bytes", out.nbytes)
    if dev.type != "cuda":
        return runs, state[-1], (out, None)
    host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True).copy_(
        out, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return runs, state[-1], (host, event)


def _finish_entry_group(runs: list, fetch, block_size: int,
                        pieces: list) -> None:
    """Wait for a group's copy (_issue_entry_group) and append each run's
    piece to its payload's list in `pieces`, as _fetch_piece gives it: (its
    start phase, its bits, its cut, its bytes as a numpy view of the copy).
    ZippyError for a run the join refused."""
    host, event = fetch
    if event is not None:
        with profiling.span("encode.wait"):
            event.synchronize()
    host = host.numpy()
    state = host[:64 * len(runs)].view(np.int64).reshape(-1, 4)
    at = state.nbytes
    for t, (p, run) in enumerate(runs):
        phase = int(state[2 * t, join_kernels.PHASE])
        _, bits, cut, err = state[2 * t + 1].tolist()
        _check_join(err)
        pieces[p].append((phase, bits, cut,
                          host[at:at + (phase + bits + 7) // 8]))
        at += 4 * join_kernels.piece_words(len(run), block_size)


def _stored_stream(data) -> bytes:
    """The level-0 stream of a payload, read where it lies: a tensor is
    fetched, host bytes are not uploaded."""
    data = (as_u8_tensor(data).cpu().numpy() if isinstance(data, torch.Tensor)
            else np.frombuffer(host_bytes(data), np.uint8))
    if not len(data):
        return _empty_stream()
    out = _ByteBitAppender()
    _append_block(out, "stored", None, None, 0, data, len(data), True)
    return bytes(out.out)


def _entry_views(payloads, level: int, block_size: int,
                 device) -> list[list]:
    """deflate_entries' streams, each as a list of byte views (numpy uint8
    arrays, or bytes) that b"".join joins into it."""
    if not MIN_BLOCK <= block_size <= (1 << 17) - HIST:
        raise ZippyError(f"block_size must lie in [{MIN_BLOCK}, "
                         f"{(1 << 17) - HIST}]")
    if level == 0:
        return [[_stored_stream(p)] for p in payloads]
    dev = resolve_devices([device])[0]
    payloads, held = payload_tensors(payloads, dev)
    lits_only = level == -2
    k, lazy, min3 = _level_params(1 if lits_only else level)
    params = {"k": k, "lazy": lazy, "min3": min3, "lits_only": lits_only}
    gmax = _group_size(k, block_size)
    groups = []
    for hist in (0, HIST):
        rows = list(_entry_rows(payloads, block_size, hist))
        groups += [(hist, rows[i:i + gmax])
                   for i in range(0, len(rows), gmax)]
    pieces: list = [[] for _ in payloads]
    keep: list = []
    carry = pending = None
    for group in groups + [None]:
        issued = None
        if group is not None:
            hist, rows = group
            with profiling.span("encode.issue"):
                runs, carry, fetch = _issue_entry_group(
                    payloads, rows, block_size, hist, params, dev, keep,
                    carry)
            issued = runs, fetch
        if pending is not None:
            # The next group runs on the card while this one is fetched.
            with profiling.span("fetch"):
                _finish_entry_group(*pending, block_size, pieces)
            del keep[:-1]           # all but the next group's upload
        pending = issued
    del held
    views = [_join_pieces(run)[0] if run else [_empty_stream()]
             for run in pieces]
    profiling.count("fetch.used_bytes", sum(
        len(v) for stream, run in zip(views, pieces) if run for v in stream))
    return views


def deflate_entries(payloads, level: int, block_size: int = BLOCK,
                    device=None, *, views: bool = False) -> list:
    """One raw DEFLATE stream per payload, each the stream of
    `deflate(payload, level, block_size, device)`, with the payloads' blocks
    encoded together: every block of every non-empty payload is a row of
    shared groups of _group_size rows, so many small payloads take a few
    groups (each of which costs about the same on the card whatever it
    holds) rather than one each. Rows are encoded independently, each with
    its own length and history, so the bytes do not depend on the
    grouping. A single-block payload's rows take no history and a longer
    payload's take HIST: the two kinds go in separate groups.

    A payload is bytes-like, str or a 1-D uint8 tensor. Tensors on
    `device` (None: the CUDA card) are read where they lie; host bytes go
    there in one upload first (common.payload_tensors), so the streams are
    the same whichever form a payload comes in. Each group's rows are
    gathered on the card as it is issued, and each payload's run of rows in
    it is joined on the card into one piece of that payload's stream (K10,
    as deflate_runs joins a group), a stored row from the group's own
    bytes; the pieces come back in one copy a group, with no host sync, and
    the next group is issued before the host waits for a group's copy, so
    the card holds about one group's intermediates at a time. The host
    only ORs the byte where two pieces of a stream meet. Level 0 frames
    each payload as stored blocks where it lies: a tensor is fetched, host
    bytes stay on the host.

    Returns each stream as bytes; with `views`, as a list of byte views
    that b"".join joins into it, for a writer that joins them into its own
    output once."""
    check_level(level)
    streams = _entry_views(payloads, level, block_size, device)
    if views:
        return streams
    with profiling.span("framing"):
        return [b"".join(stream) for stream in streams]


def deflate(data, level: int, block_size: int = BLOCK,
            device=None) -> bytes:
    """Raw DEFLATE stream of host bytes via the device pipeline: one upload
    to `device` (None: the CUDA card), then the encode of `deflate_array`
    with level -1 as level 6, as zippy_tpu's `deflate` maps it."""
    check_level(level)
    if isinstance(data, str):
        data = data.encode("utf-8")
    x = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
    return deflate_runs(x, level, level, block_size, resolve_devices([device]))
