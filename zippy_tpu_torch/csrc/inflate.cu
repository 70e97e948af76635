// Hand-written Hopper (sm_90a) kernels for the device decode's per-block
// code tables and its token extraction.
//
// Built by zippy_tpu_torch/ops/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: each entry point takes raw device pointers and
// the caller's stream, launches one kernel, allocates nothing, and returns
// the first CUDA error it met (0 when the launch was accepted).
//
// K9 zt_block_tables replaces `_cmp_tables`
//    (zippy_tpu/ops/inflate_device.py:176) as `_build_lane_tables` (:229)
//    applies it to the litlen half and the distance half of the scan's
//    code-length records. In the port its plain version is
//    inflate_kernels.block_tables_plain, whose (rows, 382) int32 output it
//    equals element for element: per row, for the 288 litlen symbols and
//    then the 30 distance symbols, fc (16) = first code + count per length
//    (the Moffat boundaries), off (16) = rank base - first code, and E (S)
//    = `ent | len` of the symbol at each canonical rank, 0 where no symbol
//    has that rank (ent: inflate_kernels._LL_ENT, _D_ENT). Lengths are
//    clamped to 0..15 first, as the plain version clamps them: a corrupt
//    stream's record may hold any byte. Ranks of symbols with a nonzero
//    length are unique (each length's symbols take the ranks sym_base[len]
//    .. sym_base[len] + count[len] - 1), so no two write one slot, and all
//    lie below S (at most S symbols have a length), so the plain version's
//    spare column for a rank at or past S is never reached.
//
//    Bound: the launch. A row is 318 bytes in and 1,528 out, about 30
//    operations a symbol; a batch of 32 CFG_L tiles is 2,048 rows, a few
//    MB. Past the launch, K9's time is a CTA's path (two round trips and
//    three barriers) and the rate at which the SMs run all CTAs'
//    instructions.
//    Design: one CTA of kTableWarps = 4 warps a row, one symbol a lane in
//    groups of 32 (the 288 litlen symbols are groups 0..8, the 30 distance
//    symbols group 9; warp w takes groups w, w + 4, w + 8), so that a
//    1,472-row batch is 5,888 warps, all resident at once on 132 SMs (a
//    warp a group for both codes at once would be 14,720 warps, two
//    waves):
//    - every lane loads its lengths and its symbols' entries (ll_ent,
//      d_ent) at the start, none waiting on another;
//    - a symbol's rank among its group's symbols of its length is the
//      lanes of its __match_any_sync group below it, and the group's
//      lowest lane writes the group's count of that length to shared
//      memory (up to three independent rounds a lane);
//    - warp 0's lanes b = 0..15 (litlen) and 16 + b (distance) sum length
//      b's counts over the code's groups, keeping each group's
//      predecessors; one 16-lane scan gives first[b] = sum_{1 <= j < b}
//      count[j] << (b - j) (the scan of count[j] << (15 - j), shifted
//      back) and sym_base[b] = sum_{1 <= j < b} count[j]; they write fc
//      and off and each group's rank base per length;
//    - each symbol of nonzero length writes its entry at its group's base
//      for its length plus its rank, straight to device memory: the
//      ranks fill 0 .. total - 1, and the slots from the code's total on
//      are zeroed by their own lanes, so each slot is written once.

// K4 zt_inflate_extract replaces the jnp/XLA `_extract`
//    (zippy_tpu/ops/inflate_device.py:268) with `_cmp_decode` (:246) and
//    `_rev15` (:152). One launch serves a batch of tiles. Every busy segment
//    lane of every tile decodes up to k sequential DEFLATE tokens from its
//    bit offset, with the Huffman tables of its block, and writes them
//    packed as the reference does:
//      out[i][col] = out_len << 16 | literal       (a literal)
//                  = out_len << 16 | (dist + 256)  (a match)
//                  = 0                             (i >= ntok)
//    Tile t's busy lanes 0 .. used_t - 1 are the columns lane_base[t] ..
//    lane_base[t + 1] - 1; the padding lanes of the tiles' fixed-size
//    segment tables are neither run nor written.
//    Tables, per block, 382 int32 (ops/inflate_kernels.TABLE_WORDS): the
//    Moffat boundaries fc = first + count and rank offsets off = rank_base
//    - first per code length, and the rank -> entry row E, for the litlen
//    code (16, 16, 288) and the distance code (16, 16, 30); tile t's
//    blocks are rows t * nblk .. t * nblk + nblk - 1.
//
//    Bound: the bytes, the packed output of the busy lanes above all (4 k
//    bytes a lane, about 4.3 MB for a CFG_L tile; a token decode needs only
//    13-31 operations). Each step needs the bit position the step before it
//    produced, so a lane is a chain of k dependent decodes, and the kernel
//    reaches its bound only with enough lanes in flight to hide the chain.
//    In practice it is near issue-bound: a step on the staged path is about
//    80 instructions, and 44 warps a SM keep the schedulers busy.
//    Design:
//    - The grid covers every busy lane of the batch. A CTA takes
//      kThreads = 128 consecutive busy lanes of one tile; cta_base, a
//      prefix made on the host, maps CTAs to tiles. A batch of 23 CFG_L
//      tiles puts about 770,000 lanes in flight for the card's 270,336
//      thread slots (one tile alone had about 33,500).
//    - A CTA's lanes are in stream order, so they use a contiguous run of
//      block rows. The CTA stages the first kRows = 2 rows of that run in
//      shared memory (one 64 KiB encoder block, or one zlib block of 16 Ki
//      symbols, spans 500-1000 lanes, so 128 lanes meet one or two rows),
//      and builds from each a first-level table of 2^kFastBits = 512
//      entries per code: entry p is the comparison decode's entry for every
//      15-bit window whose first 9 code bits are p, where the other 6 bits
//      cannot change it, and 0 where they can (codes longer than 9 bits).
//      Those take the compares of lengths 10..14 from the staged row (the
//      9 shorter boundaries are known to be exceeded). A token then costs
//      three dependent memory round trips (the window's words, the litlen
//      entry, the distance entry) instead of six or seven.
//    - A lane whose row lies outside the staged run (blocks shorter than
//      128 lanes) reads it from device memory through the read-only cache,
//      inside this kernel, and adds one to *off_run when that is given.
//    - The window is 64 bits from three consecutive words, by two funnel
//      shifts. Neighbouring lanes start some 37 bytes apart in the stream,
//      so one warp's word load from device memory touches about ten cache
//      lines. The CTA therefore copies its stretch of the stream, from its
//      first lane's word to the next CTA's first lane's word + 2, at most
//      kWinWords = 2048 words (a CTA needs about 1,200 on the 64 MiB
//      streams), into shared memory with coalesced loads, and a lane reads
//      its three words from there whenever they lie in it.
//    - Shared memory per CTA: kRows * (382 + 2 * 512) * 4 + 2048 * 4 =
//      19,440 bytes. __launch_bounds__ asks for kCtasPerSm = 11 CTAs a SM,
//      which caps the registers at 46 (nvcc then takes 40; uncapped it
//      takes 56, and 9 CTAs fit), and 11 CTAs' shared memory fits the SM's
//      228 KB.
//    - Each warp finds its CTA's tile with one ballot over cta_base, not a
//      loop of dependent loads.
//    Every word index is clamped to its tile's [0, nwords), every block
//    row to its tile's [0, nblk), as the reference's gathers clamp.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

// Offsets inside one block's table row (int32 words).
constexpr int kFcL = 0;
constexpr int kEL = 32;
constexpr int kNL = 288;
constexpr int kFcD = kEL + kNL;     // 320
constexpr int kOffD = kFcD + 16;    // 336
constexpr int kED = kOffD + 16;     // 352
constexpr int kND = 30;
constexpr int kTableWords = kED + kND;  // 382
// Inside one code's part of a row: fc at +0, off at +16, E at +32.
constexpr int kOff = 16;
constexpr int kE = 32;

constexpr int kThreads = 128;
constexpr int kRows = 2;
constexpr int kFastBits = 9;
constexpr int kFast = 1 << kFastBits;
constexpr int kWinWords = 2048;
constexpr int kCtasPerSm = 11;

template <bool kShared>
__device__ __forceinline__ int32_t ld(const int32_t* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Canonical Huffman decode by comparisons (Moffat) on one code's part of a
// table row `c`: `r` is the bit-reversed 15-bit window (MSB-first code
// space). The code length is 1 + the number of exceeded boundaries; the
// symbol's entry is E[code + off[len]], 0 for a rank outside the row. The
// exceeded boundaries are always those of lengths 1 .. cl - 1 (tables as
// `_cmp_tables` builds them have fc[j + 1] >= 2 fc[j]), so a caller that
// knows the first kFirst - 1 are exceeded starts at kFirst.
template <bool kShared, int kFirst>
__device__ __forceinline__ int32_t cmp_decode(const int32_t* c, int n,
                                              int32_t r, int32_t* cl_out) {
  int32_t cl = kFirst;
#pragma unroll
  for (int len = kFirst; len <= 14; ++len)
    cl += (r >> (15 - len)) >= ld<kShared>(c + len) ? 1 : 0;
  const int32_t rank = (r >> (15 - cl)) + ld<kShared>(c + kOff + cl);
  *cl_out = cl;
  return (rank >= 0 && rank < n) ? ld<kShared>(c + kE + rank) : 0;
}

// The code at the low end of `bits` (LSB-first stream order). With staged
// tables: the first-level table's entry (which holds its code length in
// its low 4 bits, E = symbol | length), or for a 0 there, whose code is
// longer than kFastBits, the compares of lengths kFastBits + 1 .. 14.
// Without: all 14 compares.
template <bool kShared>
__device__ __forceinline__ int32_t decode(const int32_t* c,
                                          const int32_t* fast, int n,
                                          uint32_t bits, int32_t* cl) {
  const int32_t r = (int32_t)(__brev(bits) >> 17);
  if constexpr (kShared) {
    const int32_t e = fast[r >> (15 - kFastBits)];
    if (e != 0) {
      *cl = e & 15;
      return e;
    }
    return cmp_decode<true, kFastBits + 1>(c, n, r, cl);
  } else {
    return cmp_decode<false, 1>(c, n, r, cl);
  }
}

// One code's first-level table from its staged part of a row, in shared
// memory: entry p is the compare decode's entry for the windows starting
// with p when the boundaries of lengths 1..9 give a length cl <= 9, else 0.
// Tables as `_cmp_tables` builds them have fc[j + 1] >= 2 fc[j], so a
// prefix below boundary cl stays below every longer one: the other 6 bits
// cannot change cl, the rank, or the entry, which is then that of a symbol
// of length cl (E = symbol | length, never 0).
__device__ __forceinline__ void build_fast(const int32_t* c, int n,
                                           int32_t* fast) {
  int32_t fc[kFastBits + 1];
#pragma unroll
  for (int len = 1; len <= kFastBits; ++len) fc[len] = c[len];
#pragma unroll
  for (int q = 0; q < kFast / kThreads; ++q) {
    const int32_t p = (int32_t)threadIdx.x + q * kThreads;
    int32_t cl = 1;
#pragma unroll
    for (int len = 1; len <= kFastBits; ++len)
      cl += (p >> (kFastBits - len)) >= fc[len] ? 1 : 0;
    int32_t e = 0;
    if (cl <= kFastBits) {
      const int32_t rank = (p >> (kFastBits - cl)) + c[kOff + cl];
      e = (rank >= 0 && rank < n) ? c[kE + rank] : 0;
    }
    fast[p] = e;
  }
}

// One lane's k steps; `row` is its block's table row (shared memory when
// kShared, with `fast` its two first-level tables), `win` the CTA's staged
// words w_lo .. w_lo + nwin - 1 of the tile, `out` the lane's column.
template <bool kShared>
__device__ __forceinline__ void extract_lane(
    const uint32_t* __restrict__ words, int nwords, const uint32_t* win,
    int w_lo, int nwin, const int32_t* row, const int32_t* fast,
    int32_t bit, int32_t ntok, int k, int32_t* __restrict__ out,
    int total) {
  const int n = min(max(ntok, 0), k);
  // The three words at j .. j + 2 lie in the window for j < nwin - 2.
  const unsigned in_win = (unsigned)max(nwin - 2, 0);
  for (int i = 0; i < n; ++i, out += total) {
    // 64 stream bits from `bit` on: three words (from the staged window
    // when all three lie in it; else from device memory, the index
    // clamped to the tile's words), two funnel shifts.
    const int j = (bit >> 5) - w_lo;
    uint32_t w0, w1, w2;
    if ((unsigned)j < in_win) {
      w0 = win[j];
      w1 = win[j + 1];
      w2 = win[j + 2];
    } else {
      const int iw = min(max(bit >> 5, 0), nwords - 1);
      w0 = __ldg(words + iw);
      w1 = __ldg(words + min(iw + 1, nwords - 1));
      w2 = __ldg(words + min(iw + 2, nwords - 1));
    }
    const uint32_t sh = (uint32_t)bit & 31u;
    const uint32_t lo = __funnelshift_r(w0, w1, sh);
    const uint32_t hi = __funnelshift_r(w1, w2, sh);
    int32_t cl;
    const int32_t e = decode<kShared>(row + kFcL, fast, kNL, lo, &cl);
    const bool is_lit = (e >> 5) & 1;
    const int32_t lb = (e >> 8) & 0xFF;
    const int32_t lbase = (e >> 16) & 0x1FF;
    const uint32_t lx = (uint32_t)(e >> 25) & 7u;
    const int32_t length = lbase + (int32_t)((lo >> cl) & ((1u << lx) - 1u));
    // Distance code: it starts cl + lx bits in (1..22).
    const uint32_t sh2 = (uint32_t)cl + lx;
    const uint32_t lo2 = __funnelshift_r(lo, hi, sh2);
    int32_t dcl;
    const int32_t de = decode<kShared>(row + kFcD, fast + kFast, kND, lo2,
                                       &dcl);
    const uint32_t dx = (uint32_t)(de >> 5) & 15u;
    const int32_t dist = ((de >> 16) & 0x7FFF) + 1 +
                         (int32_t)((lo2 >> dcl) & ((1u << dx) - 1u));
    if (is_lit) {
      *out = (1 << 16) | lb;
      bit += cl;
    } else {
      *out = (length << 16) | (dist + 256);
      bit += (int32_t)(sh2 + (uint32_t)dcl + dx);
    }
  }
  // Slots past the lane's token count.
  for (int i = n; i < k; ++i, out += total) *out = 0;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
inflate_extract_kernel(const uint32_t* __restrict__ words,
                       long long words_stride, int nwords,
                       const int32_t* __restrict__ seg,
                       long long seg_tile_stride, long long seg_row_stride,
                       const int32_t* __restrict__ bases, int ntiles,
                       const int32_t* __restrict__ tables, int nblk, int k,
                       int total, int32_t* __restrict__ out,
                       unsigned long long* off_run) {
  __shared__ int32_t s_rows[kRows * kTableWords];
  __shared__ int32_t s_fast[kRows][2 * kFast];
  __shared__ uint32_t s_win[kWinWords];
  __shared__ int s_lo, s_hi;

  // This CTA's tile t: the number of tiles before the last whose CTAs end
  // at or before blockIdx.x (cta_base is nondecreasing; a tile without
  // busy lanes has no CTA), counted 32 tiles at a time by a warp ballot.
  const int32_t* lane_base = bases;
  const int32_t* cta_base = bases + ntiles + 1;
  const int cta = (int)blockIdx.x;
  int t = 0;
  for (int base = 0; base < ntiles - 1; base += 32) {
    const int l = base + ((int)threadIdx.x & 31);
    t += __popc(__ballot_sync(
        0xffffffffu, l < ntiles - 1 && __ldg(cta_base + l + 1) <= cta));
  }
  const int32_t col0 = __ldg(lane_base + t);
  const int used = __ldg(lane_base + t + 1) - col0;
  const int lane = (cta - __ldg(cta_base + t)) * kThreads + (int)threadIdx.x;
  const bool busy = lane < used;
  const int32_t* tseg = seg + t * seg_tile_stride;
  const int32_t* lseg = tseg + lane;
  const int32_t* ttab = tables + (long long)t * nblk * kTableWords;
  const uint32_t* w = words + t * words_stride;
  const int blk = busy ? min(max(lseg[seg_row_stride], 0), nblk - 1) : 0;

  // The run of block rows the CTA's busy lanes use (its first lane is
  // always busy).
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = 0;
  }
  __syncthreads();
  const int wlo = __reduce_min_sync(0xffffffffu, busy ? blk : INT_MAX);
  const int whi = __reduce_max_sync(0xffffffffu, busy ? blk : 0);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s_lo, wlo);
    atomicMax(&s_hi, whi);
  }
  __syncthreads();
  const int b0 = s_lo;
  const int nrows = min(s_hi - b0 + 1, kRows);

  // Stage the run's first nrows rows (contiguous in device memory), and
  // the CTA's stream words: from its first lane's word to the next CTA's
  // first lane's word + 2, at most kWinWords.
  const int32_t* src = ttab + (long long)b0 * kTableWords;
  for (int j = (int)threadIdx.x; j < nrows * kTableWords; j += kThreads)
    s_rows[j] = __ldg(src + j);
  const int lane0 = lane - (int)threadIdx.x;
  const int w_lo = min(max(__ldg(tseg + lane0) >> 5, 0), nwords - 1);
  int w_end = nwords;
  if (lane0 + kThreads < used)
    w_end = min(max((__ldg(tseg + lane0 + kThreads) >> 5) + 3, w_lo), w_end);
  const int nwin = min(w_end - w_lo, kWinWords);
  for (int j = (int)threadIdx.x; j < nwin; j += kThreads)
    s_win[j] = __ldg(w + w_lo + j);
  __syncthreads();
  for (int r = 0; r < nrows; ++r) {
    build_fast(s_rows + r * kTableWords + kFcL, kNL, s_fast[r]);
    build_fast(s_rows + r * kTableWords + kFcD, kND, s_fast[r] + kFast);
  }
  __syncthreads();

  if (!busy) return;
  const int32_t bit = lseg[0];
  const int32_t ntok = lseg[2 * seg_row_stride];
  int32_t* o = out + col0 + lane;
  const int slot = blk - b0;
  if (slot < nrows) {
    extract_lane<true>(w, nwords, s_win, w_lo, nwin,
                       s_rows + slot * kTableWords, s_fast[slot], bit, ntok,
                       k, o, total);
  } else {
    if (off_run != nullptr) atomicAdd(off_run, 1ull);
    extract_lane<false>(w, nwords, s_win, w_lo, nwin,
                        ttab + (long long)blk * kTableWords, nullptr, bit,
                        ntok, k, o, total);
  }
}

// K9: a CTA of kTableWarps warps builds one row's two codes. Symbols come
// in kGroups groups of 32, one symbol a lane: groups 0..8 are the 288
// litlen symbols, group 9 the 30 distance symbols (lanes 0..29); warp w
// takes groups w, w + kTableWarps, ...
constexpr int kTableWarps = 4;
constexpr int kTableThreads = 32 * kTableWarps;
constexpr int kGroups = kNL / 32 + 1;   // 10
constexpr int kDistGroup = kGroups - 1;
constexpr int kRounds = (kGroups + kTableWarps - 1) / kTableWarps;
constexpr int kLensPerRow = kNL + kND;  // 318

__global__ void __launch_bounds__(kTableThreads)
block_tables_kernel(const uint8_t* __restrict__ lens8, long long tile_stride,
                    long long row_stride, int nblk,
                    const long long* __restrict__ ll_ent,
                    const long long* __restrict__ d_ent,
                    int32_t* __restrict__ out) {
  // Per group, the symbols of each length; then each length's rank base
  // in the group (the code's rank base plus the group's predecessors of
  // that length).
  __shared__ int32_t cnt_of[kGroups][16];
  __shared__ int32_t s_total[2];   // symbols of nonzero length, per code
  const int tid = (int)threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = (int)blockIdx.x;
  const uint8_t* lens = lens8 + (long long)(row / nblk) * tile_stride +
                        (long long)(row % nblk) * row_stride;
  int32_t* o = out + (long long)row * kTableWords;

  // The lengths (clamped to 15; 16: no symbol) and the entries of the
  // warp's groups, loaded first, none waiting on another.
  int len[kRounds], ent[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int g = warp + kTableWarps * r;
    len[r] = 16;
    ent[r] = 0;
    rank[r] = 0;
    if (g < kDistGroup) {
      len[r] = min((int)lens[g * 32 + lane], 15);
      ent[r] = (int32_t)ll_ent[g * 32 + lane];
    } else if (g == kDistGroup && lane < kND) {
      len[r] = min((int)lens[kNL + lane], 15);
      ent[r] = (int32_t)d_ent[lane];
    }
  }
  for (int i = tid; i < kGroups * 16; i += kTableThreads)
    (&cnt_of[0][0])[i] = 0;
  __syncthreads();

  // A symbol's rank among the group's symbols of its length: the lanes of
  // its __match_any_sync group below it; the group's lowest lane counts it.
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int g = warp + kTableWarps * r;
    if (g < kGroups) {
      const unsigned same = __match_any_sync(0xffffffffu, len[r]);
      rank[r] = __popc(same & below);
      if (len[r] < 16 && (same & below) == 0)
        cnt_of[g][len[r]] = __popc(same);
    }
  }
  __syncthreads();

  // Warp 0: lane b of the low half for the litlen code, of the high half
  // for the distance code, sums length b's counts over the code's groups
  // (each group's predecessors kept), then one 16-lane scan gives first[b]
  // = sum_{1 <= j < b} count[j] << (b - j) (the sum of count[j] << (15 -
  // j), shifted back) and sym_base[b] = sum_{1 <= j < b} count[j].
  if (warp == 0) {
    const int b = lane & 15;
    const int c = lane >> 4;
    const int g0 = c ? kDistGroup : 0, ng = c ? 1 : kDistGroup;
    int cnt[kDistGroup], pre[kDistGroup];
#pragma unroll
    for (int k = 0; k < kDistGroup; ++k)
      cnt[k] = k < ng ? cnt_of[g0 + k][b] : 0;
    int count = 0;
#pragma unroll
    for (int k = 0; k < kDistGroup; ++k) {
      pre[k] = count;
      count += cnt[k];
    }
    const int own_f = b ? count << (15 - b) : 0, own_s = b ? count : 0;
    int f = own_f, sb = own_s;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
      const int uf = __shfl_up_sync(0xffffffffu, f, d, 16);
      const int us = __shfl_up_sync(0xffffffffu, sb, d, 16);
      if (b >= d) {
        f += uf;
        sb += us;
      }
    }
    const int first = (f - own_f) >> (15 - b);
    const int sym_base = sb - own_s;
    int32_t* oc = o + (c ? kFcD : kFcL);
    oc[b] = first + count;
    oc[kOff + b] = sym_base - first;
#pragma unroll
    for (int k = 0; k < kDistGroup; ++k)
      if (k < ng) cnt_of[g0 + k][b] = sym_base + pre[k];
    if (b == 15) s_total[c] = sb;
  }
  __syncthreads();

  // E, each slot written once: a symbol of nonzero length at its rank
  // (ranks fill 0 .. total - 1), zeros from the code's total on.
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int g = warp + kTableWarps * r;
    if (g < kGroups) {
      const bool dist = g == kDistGroup;
      const int s = dist ? lane : g * 32 + lane;
      int32_t* e_out = o + (dist ? kFcD : kFcL) + kE;
      if (len[r] >= 1 && len[r] <= 15)
        e_out[cnt_of[g][len[r]] + rank[r]] = ent[r] | len[r];
      if (s < (dist ? kND : kNL) && s >= s_total[dist])
        e_out[s] = 0;
    }
  }
}

}  // namespace

extern "C" {

// K9: rows = ntiles * nblk code-length records of 318 uint8, row r at
// lens8 + (r / nblk) * tile_stride + (r % nblk) * row_stride (bytes), into
// out, rows * 382 int32; ll_ent (288) and d_ent (30) int64, the symbols'
// entries without their lengths. One CTA a row.
int zt_block_tables(const void* lens8, long long tile_stride,
                    long long row_stride, int nblk, int rows,
                    const void* ll_ent, const void* d_ent, void* out,
                    void* stream, int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0 && nblk > 0) {
    block_tables_kernel<<<rows, kTableThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)lens8, tile_stride, row_stride, nblk,
        (const long long*)ll_ent, (const long long*)d_ent, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// words: ntiles rows of nwords >= 1 uint32 (the tiles' stream words), row
// t at words + t * words_stride; seg: per tile three rows of int32 (bit
// offset into the tile's words, block row, token count), tile t's row j at
// seg + t * seg_tile_stride + j * seg_row_stride; bases: ntiles + 1 busy-
// lane prefix sums, then ntiles + 1 CTA prefix sums (ceil(used / 128)),
// ncta the last; tables: ntiles * nblk rows of 382 int32; out: k * total
// int32, row i holding every busy lane's token i; off_run: null, or one
// uint64 that counts the lanes whose block row was not staged.
int zt_inflate_extract(const void* words, long long words_stride, int nwords,
                       const void* seg, long long seg_tile_stride,
                       long long seg_row_stride, const void* bases,
                       int ntiles, int ncta, const void* tables, int nblk,
                       int k, int total, void* out, void* off_run,
                       void* stream, int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  if (ncta > 0 && k > 0) {
    inflate_extract_kernel<<<ncta, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, words_stride, nwords, (const int32_t*)seg,
        seg_tile_stride, seg_row_stride, (const int32_t*)bases, ntiles,
        (const int32_t*)tables, nblk, k, total, (int32_t*)out,
        (unsigned long long*)off_run);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
