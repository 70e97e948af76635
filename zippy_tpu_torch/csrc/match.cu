// Hand-written Hopper (sm_90a) kernels for the encoder's match finding.
//
// Built by zippy_tpu_torch/ops/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: each entry point takes raw device pointers and
// the caller's stream, launches its kernels in order on that stream,
// allocates nothing, never waits for the card, and returns the first CUDA
// error it met (0 when every launch was accepted).
//
// K7 replaces the jnp/XLA `find_tokens` of zippy_tpu/ops/deflate_device.py
// (:94-360): the token cover of a group of G rows. A row is `hist` bytes of
// read-only history, the N-byte block and PAD bytes, D = hist + N + PAD;
// n and hist_len are per row. What it computes, per row:
//   - the hash of every position p < NA = hist + N, h = (v * 0x9E3779B1)
//     >> 17 of the little-endian word v at p, and the sort of the keys
//     (h << 17 | p): a position's k candidates are the k positions before
//     it in that order with the same h (its k most recent occurrences);
//   - for k >= 4, each ok candidate ranked by its equal leading bytes up to
//     32 (not capped at the block's end), score (len << 17) + pos (a
//     candidate that is not ok scores its raw pos, -1 for none), the top
//     three chosen by first maximum with each winner masked to -1, and
//     those three rescored up to 64 bytes capped at nrem = n - i; for
//     k < 4 every candidate scored at 64 bytes, capped at nrem. A
//     candidate is ok when it is >= 0, not in the unreal part of the
//     history (< hist - hist_len) and at most 32768 bytes back;
//   - a best length of exactly 64 extended by up to 194 more equal bytes,
//     then capped at min(nrem, 258);
//   - under min3 (levels 7-9): the one most recent position with the same
//     3-byte hash, taken as a length-3 match when its three bytes are
//     equal, it is at most 4096 back, nrem >= 3, the position has no >= 4
//     match and the one two ahead has none either;
//   - under lazy: a match dropped where the next position's is longer;
//   - the token cover: the walk 0 -> i + step(i) -> ... (step the match's
//     length or 1; every position >= n steps to N);
//   - each token's symbol, length and distance codes, and the litlen and
//     distance histograms (end-of-block counted once).
//
// Bound: per position the reference XORs k * 8 + 3 * 17 + 50 words (k >= 4;
// k = 12 at level 6) and finds the first set bit of k + 4 of them, about
// 7.7e8 operations a 55-row group, against 157 MB of rows in and outputs
// out (chip_smoke.find_work): bytes bound, 0.047 ms at 3.35 TB/s. The XLA
// twin materialises every candidate's byte windows, (G, N, k, 8) words and
// more (gigabytes a group); here nothing but a few int32 per position
// reaches device memory before the outputs.
//
// Design: LAUNCHES_PER_GROUP (ops/match_kernels.py) launches a group,
// whatever the data, k or min3 (k7_literals alone under lits_only), no
// library kernel and no host sync. Under min3 the 3-byte keys are G more
// rows of the sort's launches (rows G..2G).
//   Sort (6 launches): a stable LSD counting sort of each row's NA keys on
//   their 15 hash bits, 8 low then 7 high; the positions are already in
//   order, so it gives the order of the unique keys exactly. Tiles of 4096
//   keys, a CTA each (24 a 98,304-key row, about 1,300 CTAs a group).
//   1. k7_count: each tile's low-digit histogram, its keys made from the
//      row's bytes; it also zeroes the histogram outputs (end-of-block
//      counted) for k7_emit's atomics;
//   2. k7_scan: per key row, each (tile, digit)'s first index in the
//      pass's output: the digit's total before it and its count in the
//      tiles before;
//   3. k7_scatter<0>: per tile, each key's stable rank among its tile's
//      keys of its digit (a warp's 32 keys a round: the lanes of the same
//      digit from ballots of its bits, per-warp counters in shared memory;
//      then the warps in order); the tile is ordered in shared memory and
//      written out in runs of one digit. One digit holding every key (an
//      all-zero row) costs no more than any other;
//   4. k7_hist: each tile's high-digit histogram of that output;
//   5. k7_scan again;
//   6. k7_scatter<1>: the sorted keys, and each block position's index in
//      the order (inv; the history's are never read).
//   7. k7_match: one thread a position, 1024 positions a CTA of 256
//      threads; the row's bytes from 32 KiB before the CTA's first position
//      to PAD past its last in shared memory (34 KB), staged in 16-byte
//      loads from the 16-byte boundary below them (rows of D bytes are not
//      16-byte aligned); the candidates (the entries before inv[p] in the
//      order), the ranking, the rescoring, the extension and the min3 test
//      (its candidate the entry before the position in the 3-byte order),
//      each compare one shared-memory load a word; the position's best
//      length and distance and its 3-gram distance (0: none) go to scratch.
//   The cover, over chunks of 1024 positions (>= 258, so a step from a
//   chunk lands in the next one, or at N past the block's end), a CTA a
//   chunk (G x N/1024 CTAs) but for the chain:
//   8. k7_exits: each position's token (min3's demotion and the lazy rule
//      read the best lengths of the next three positions) and its step;
//      then one warp, from the chunk's end back 32 positions at a time,
//      gives each its exit from the chunk (the walk's first position past
//      it): a step past the 32 reads the exit found already, steps within
//      them are resolved by pointer jumping through shuffles (5 rounds).
//      The exits of the chunk's first 258 positions, the ones the walk can
//      enter it at, go to scratch as offsets past the chunk's end (or N);
//   9. k7_chain: a CTA a row stages its chunks' exits in shared memory and
//      one thread chains the chunks' entries from position 0 (one lookup a
//      chunk, the one serial part across chunks);
//   10. k7_emit: the tokens again, a bit a position where the step is to
//      the next position; one thread walks from the chunk's entry, a run
//      of such steps a 32-bit word at a time and a match a step, marking
//      the positions it visits; then the seven outputs, coalesced, and the
//      histograms (counted in shared memory, then one global atomic a bin
//      a CTA).
// Every output equals the twin's element for element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kPad = 264;          // bytes after the block (>= 64 + 194 + 6)
constexpr int kCmp = 64;           // L_CMP: bytes scored while ranking
constexpr int kRankWords = 8;      // 32 bytes ranked per candidate, k >= 4
constexpr int kCmpWords = kCmp / 4;
constexpr int kExt = 194;          // L_EXT: the extension past L_CMP
constexpr int kExtWords = (kExt + 3) / 4;
constexpr int kWindow = 32768;     // DEFLATE's window
constexpr int kMaxMatch = 258;
constexpr int kTooFar3 = 4096;     // min3's distance limit (zlib's TOO_FAR)
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr int kHashShift = 32 - 15;
constexpr int kPosBits = 17;
constexpr uint32_t kPosMask = (1u << kPosBits) - 1;
// Keys (h << 17 | p) are uint32; flipping the top bit makes their int32
// order the unsigned order (the plain version sorts them as int32).
constexpr uint32_t kFlip = 0x80000000u;
constexpr unsigned kAll = 0xffffffffu;

// The sort.
constexpr int kSortThreads = 512;
constexpr int kSortTile = 4096;    // keys a CTA
constexpr int kKeysPerThread = kSortTile / kSortThreads;
constexpr int kSortWarps = kSortThreads / 32;
// A pass's histogram row (the high pass uses 128 of it).
constexpr int kDigits = 256;
constexpr int kMaxTiles = (1 << kPosBits) / kSortTile;

// The match.
constexpr int kThreads = 256;
// Positions a CTA. Each stages the 32 KiB before them; 2048 and 4096
// (about a half and a quarter of the bytes staged a position) were no
// faster on the H100.
constexpr int kSpan = 1024;
// A match CTA's bytes: 32 KiB before its first position, its span and PAD
// after it, up to 15 bytes below them for the 16-byte boundary and a slack
// chunk that a funnel read past the last needed byte may touch.
constexpr int kWinChunks = (kWindow + kSpan + kPad + 48 + 15) / 16;

// The cover.
constexpr int kChunk = 1024;       // >= kMaxMatch
// CTAs of a chunk each.
constexpr int kExitThreads = 64;
constexpr int kEmitThreads = 128;
constexpr int kEntries = kMaxMatch;  // where the walk can enter a chunk
constexpr int kExitStride = 264;   // >= kEntries, 528 bytes: 16-byte rows
constexpr uint16_t kToN = 0xFFFF;  // an exit at N
constexpr int kChainThreads = 512;
constexpr int kLitlen = 286, kDistSyms = 30;

int blocks_for(long long n, int per) { return (int)((n + per - 1) / per); }

__device__ __forceinline__ uint32_t hash4(uint32_t v) {
  return (v * kHashMul) >> kHashShift;
}

// The little-endian word of the 4 bytes at byte offset `off` of `win`.
__device__ __forceinline__ uint32_t word_at(const uint32_t* win, int off) {
  return __funnelshift_r(win[off >> 2], win[(off >> 2) + 1], (off & 3) * 8);
}

// The words at byte offsets off, off + 4, ... of `win`, one shared-memory
// load each: a funnel shift of the aligned word before and the one after,
// which the next word reuses.
struct WordStream {
  const uint32_t* p;
  int shift;
  uint32_t lo;
  __device__ __forceinline__ WordStream(const uint32_t* win, int off)
      : p(win + (off >> 2)), shift((off & 3) * 8), lo(*p) {}
  __device__ __forceinline__ uint32_t next() {
    const uint32_t hi = *++p;
    const uint32_t w = __funnelshift_r(lo, hi, shift);
    lo = hi;
    return w;
  }
};

// Equal leading bytes of the words at a and b, up to w1 words; 4 * w1
// when all are equal.
__device__ __forceinline__ int equal_bytes(const uint32_t* win, int a, int b,
                                           int w1) {
  WordStream sa(win, a), sb(win, b);
  for (int w = 0; w < w1; ++w) {
    const uint32_t x = sa.next() ^ sb.next();
    if (x) return 4 * w + ((__ffs(x) - 1) >> 3);
  }
  return 4 * w1;
}

// The same against the i side's first 16 words, held in registers, from
// word W0 (the earlier ones known equal) up to W1.
template <int W0, int W1>
__device__ __forceinline__ int equal_bytes_i(const uint32_t (&wi)[kCmpWords],
                                             const uint32_t* win, int b) {
  WordStream sb(win, b + 4 * W0);
#pragma unroll
  for (int w = W0; w < W1; ++w) {
    const uint32_t x = wi[w] ^ sb.next();
    if (x) return 4 * w + ((__ffs(x) - 1) >> 3);
  }
  return 4 * W1;
}

// A key's digit in sort pass PASS: its hash's low 8 bits, then its high 7.
template <int PASS>
__device__ __forceinline__ int digit_of(int32_t key) {
  const uint32_t h = ((uint32_t)key ^ kFlip) >> kPosBits;
  return PASS == 0 ? (int)(h & 255u) : (int)(h >> 8);
}

// Exclusive prefix sum of v over threads 0..255 of the block (the others
// pass 0 and get sums past them); every thread calls it. `scratch` holds
// an int a warp of the block.
__device__ int block_scan256(int v, int* scratch) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[w] = x;
  __syncthreads();
  int base = 0;
  for (int i = 0; i < w && i < kDigits / 32; ++i) base += scratch[i];
  __syncthreads();
  return base + x - v;
}

// The lanes of `lanes` whose v has this lane's low BITS bits, from BITS
// ballots; every lane of the warp calls it. (__match_any_sync gives the
// same, but was slower on the H100 where a warp holds many values.)
template <int BITS>
__device__ __forceinline__ unsigned peers(unsigned lanes, int v) {
  unsigned same = lanes;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const bool bit = v >> b & 1;
    const unsigned m = __ballot_sync(kAll, bit);
    same &= bit ? m : ~m;
  }
  return same;
}

// Adds one to hist[d] for every lane of the warp where ok: one
// shared-memory atomic where those lanes share one d (an all-zero row),
// else one a lane; every lane calls it.
__device__ __forceinline__ void count_digit(int* hist, bool ok, int d) {
  const unsigned lanes = __ballot_sync(kAll, ok);
  const int lead = __ffs(lanes) - 1;
  const int d0 = __shfl_sync(kAll, d, lead < 0 ? 0 : lead);
  if (__all_sync(kAll, !ok || d == d0)) {
    if ((int)(threadIdx.x & 31) == lead) atomicAdd(&hist[d0], __popc(lanes));
  } else if (ok) {
    atomicAdd(&hist[d], 1);
  }
}

// Key row r's key at position p (r < G: the hash of row r's word at p;
// r >= G: of row r - G's 3-byte word), flipped.
__device__ __forceinline__ int32_t key_at(const uint8_t* __restrict__ data,
                                          int D, int G, int r, int p) {
  const bool three = r >= G;
  const uint8_t* b = data + (size_t)(three ? r - G : r) * D + p;
  const uint32_t v = (uint32_t)b[0] | (uint32_t)b[1] << 8 |
                     (uint32_t)b[2] << 16 | (three ? 0u : (uint32_t)b[3] << 24);
  return (int32_t)((hash4(v) << kPosBits | (uint32_t)p) ^ kFlip);
}

// Launch 1: tile blockIdx.x of key row blockIdx.y's low-digit histogram;
// tile 0 of each row g < G zeroes row g's histogram outputs, end-of-block
// counted, where there are any.
__global__ void __launch_bounds__(kSortThreads)
k7_count(const uint8_t* __restrict__ data, int D, int G, int NA, int nt,
         int32_t* __restrict__ tiles, int64_t* __restrict__ ll_hist,
         int64_t* __restrict__ dist_hist) {
  __shared__ int h[kDigits];
  const int r = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  if (tid < kDigits) h[tid] = 0;
  if (t == 0 && r < G && ll_hist != nullptr) {  // null from zt_match_sort
    for (int j = tid; j < kLitlen; j += kSortThreads)
      ll_hist[(size_t)r * kLitlen + j] = j == 256;
    if (tid < kDistSyms) dist_hist[(size_t)r * kDistSyms + tid] = 0;
  }
  __syncthreads();
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int p = t * kSortTile + j * kSortThreads + tid;
    const bool ok = p < NA;
    count_digit(h, ok, ok ? digit_of<0>(key_at(data, D, G, r, p)) : 0);
  }
  __syncthreads();
  if (tid < kDigits) tiles[((size_t)r * nt + t) * kDigits + tid] = h[tid];
}

// Launches 2 and 5: per key row (a CTA of 256 threads, a thread a digit),
// the (tile, digit) counts in `tiles` become each one's first index in the
// pass's output.
__global__ void __launch_bounds__(kDigits)
k7_scan(int nt, int32_t* __restrict__ tiles) {
  __shared__ int scratch[kDigits / 32];
  const int d = threadIdx.x;
  int32_t* row = tiles + (size_t)blockIdx.x * nt * kDigits;
  int c[kMaxTiles];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) c[t] = t < nt ? row[t * kDigits + d] : 0;
  int run = 0;
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    const int x = c[t];
    c[t] = run;
    run += x;
  }
  const int base = block_scan256(run, scratch);
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t)
    if (t < nt) row[t * kDigits + d] = base + c[t];
}

// Launches 3 and 6: tile blockIdx.x of key row blockIdx.y to its places in
// `out`, stable; the low pass makes its keys from the bytes, the high pass
// reads the low pass's output (`in`) and also writes each block position's
// index in the order to inv, (R, NA - hist).
template <int PASS>
__global__ void __launch_bounds__(kSortThreads, 2)
k7_scatter(const uint8_t* __restrict__ data, int D, int G, int hist,
           const int32_t* __restrict__ in, int NA, int nt,
           const int32_t* __restrict__ tiles, int32_t* __restrict__ out,
           int32_t* __restrict__ inv) {
  __shared__ uint16_t wc[kSortWarps][kDigits];  // per warp, then warp starts
  __shared__ int32_t skeys[kSortTile];
  __shared__ int ls[kDigits], go[kDigits];
  __shared__ int scratch[kSortWarps];
  const int r = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const size_t row = (size_t)r * NA;
  const int lo = t * kSortTile, cnt = min(kSortTile, NA - lo);
  for (int i = tid; i < kSortWarps * kDigits; i += kSortThreads)
    (&wc[0][0])[i] = 0;
  if (tid < kDigits) go[tid] = tiles[((size_t)r * nt + t) * kDigits + tid];
  __syncthreads();

  // Warp w ranks keys [256 w, 256 w + 256) of the tile, 32 a round.
  int32_t key[kKeysPerThread];
  int rank[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = w * (32 * kKeysPerThread) + j * 32 + lane;
    const bool ok = i < cnt;
    key[j] = !ok ? 0 : PASS == 0 ? key_at(data, D, G, r, lo + i)
                                 : in[row + lo + i];
  }
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = w * (32 * kKeysPerThread) + j * 32 + lane;
    const bool ok = i < cnt;
    const int d = ok ? digit_of<PASS>(key[j]) : 0;
    const unsigned same =
        peers<PASS == 0 ? 8 : 7>(__ballot_sync(kAll, ok), d);
    const int leader = ok ? __ffs(same) - 1 : lane;
    int before = 0;
    if (ok && lane == leader) {
      before = wc[w][d];
      wc[w][d] = (uint16_t)(before + __popc(same));
    }
    before = __shfl_sync(kAll, before, leader);
    rank[j] = before + __popc(same & ((1u << lane) - 1));
    __syncwarp();
  }
  __syncthreads();

  // Each digit's warps in order, then the digits in order.
  int total = 0;
  if (tid < kDigits)
    for (int v = 0; v < kSortWarps; ++v) {
      const int c = wc[v][tid];
      wc[v][tid] = (uint16_t)total;
      total += c;
    }
  const int start = block_scan256(tid < kDigits ? total : 0, scratch);
  if (tid < kDigits) ls[tid] = start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = w * (32 * kKeysPerThread) + j * 32 + lane;
    if (i < cnt) {
      const int d = digit_of<PASS>(key[j]);
      skeys[ls[d] + wc[w][d] + rank[j]] = key[j];
    }
  }
  __syncthreads();

  // Out in order: a digit's keys of this tile are one run in `out`.
  for (int i = tid; i < cnt; i += kSortThreads) {
    const int32_t k = skeys[i];
    const int d = digit_of<PASS>(k);
    const int at = go[d] + i - ls[d];
    out[row + at] = k;
    const int pos = (int)(((uint32_t)k ^ kFlip) & kPosMask);
    if (PASS == 1 && pos >= hist)
      inv[(size_t)r * (NA - hist) + pos - hist] = at;
  }
}

// Launch 4: each tile's high-digit histogram of the low pass's output.
__global__ void __launch_bounds__(kSortThreads)
k7_hist(const int32_t* __restrict__ in, int NA, int nt,
        int32_t* __restrict__ tiles) {
  __shared__ int h[kDigits];
  const int r = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  if (tid < kDigits) h[tid] = 0;
  __syncthreads();
  const int lo = t * kSortTile, cnt = min(kSortTile, NA - lo);
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = j * kSortThreads + tid;
    const bool ok = i < cnt;
    count_digit(h, ok, ok ? digit_of<1>(in[(size_t)r * NA + lo + i]) : 0);
  }
  __syncthreads();
  if (tid < kDigits) tiles[((size_t)r * nt + t) * kDigits + tid] = h[tid];
}

// Launch 7: one thread a position, KMAX >= k candidates held in registers.
// At least five CTAs an SM up to KMAX 4, four up to 12, three above: the
// compares wait on shared memory, and on the H100 these were faster than
// fewer CTAs with more registers, the spills at KMAX 16 and 32 included.
template <int KMAX>
__global__ void __launch_bounds__(kThreads,
                                  KMAX <= 4 ? 5 : KMAX <= 12 ? 4 : 3)
k7_match(const uint8_t* __restrict__ data, int D, int hist, int N,
         const int64_t* __restrict__ n_rows,
         const int64_t* __restrict__ hist_len_rows,
         const int32_t* __restrict__ sorted, const int32_t* __restrict__ inv,
         int k, bool min3, int32_t* __restrict__ lbest,
         int32_t* __restrict__ dbest, int32_t* __restrict__ m3) {
  __shared__ uint4 win4[kWinChunks];
  const uint32_t* win = reinterpret_cast<const uint32_t*>(win4);
  const int g = blockIdx.y, G = gridDim.y;
  const int i0 = blockIdx.x * kSpan;
  const int NA = hist + N;
  const uint8_t* row = data + (size_t)g * D;
  const long long n = n_rows[g];
  const long long lo_ok = (long long)hist - hist_len_rows[g];

  // Stage the row's bytes [ws, we) (and whatever lies past we) from the
  // 16-byte boundary at or below row + ws: row byte x is window byte
  // x - wbase. Chunks that reach outside the tensor are read bytewise.
  const int ws = max(hist + i0 - kWindow, 0);
  const int we = min(D, hist + i0 + kSpan + kPad);
  const uint8_t* a0 = reinterpret_cast<const uint8_t*>(
      reinterpret_cast<uintptr_t>(row + ws) & ~(uintptr_t)15);
  const int wbase = ws - (int)(row + ws - a0);
  const int nck = (we - wbase + 15) / 16 + 1;
  const uint8_t* lo = data;
  const uint8_t* hi = data + (size_t)G * D;
  for (int c = threadIdx.x; c < nck; c += kThreads) {
    const uint8_t* src = a0 + 16 * c;
    uint4 x;
    if (src >= lo && src + 16 <= hi) {
      x = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      uint32_t b[4] = {0, 0, 0, 0};
      for (int j = 0; j < 16; ++j)
        if (src + j >= lo && src + j < hi)
          b[j >> 2] |= (uint32_t)src[j] << (8 * (j & 3));
      x = make_uint4(b[0], b[1], b[2], b[3]);
    }
    win4[c] = x;
  }
  __syncthreads();

  const int32_t* srow = sorted + (size_t)g * NA;
  for (int r = 0; r < kSpan / kThreads; ++r) {
    const int i = i0 + r * kThreads + (int)threadIdx.x;
    if (i >= N) break;
    const size_t o = (size_t)g * N + i;
    const long long rem = n - i;
    if (rem <= 0) {  // past the block's end every length is 0
      lbest[o] = 0;
      dbest[o] = 0;
      if (min3) m3[o] = 0;
      continue;
    }
    const int nrem = rem > (1 << 20) ? (1 << 20) : (int)rem;
    const int ia = hist + i;
    const int ai = ia - wbase;
    uint32_t wi[kCmpWords];
    WordStream si(win, ai);
#pragma unroll
    for (int w = 0; w < kCmpWords; ++w) wi[w] = si.next();
    const uint32_t h = hash4(wi[0]);

    // The candidates: the entries before this position in the sorted
    // order, while their hash is this position's.
    // All k loaded at once, then taken while the hash holds.
    const int s = inv[o];
    uint32_t u[KMAX];
#pragma unroll
    for (int b = 0; b < KMAX; ++b)
      u[b] = b < k && s - 1 - b >= 0 ? (uint32_t)srow[s - 1 - b] ^ kFlip : 0;
    int cand[KMAX];
    uint32_t okm = 0;
    bool live = true;
#pragma unroll
    for (int b = 0; b < KMAX; ++b) {
      int c = -1;
      if (b < k && live && s - 1 - b >= 0) {
        if ((u[b] >> kPosBits) == h)
          c = (int)(u[b] & kPosMask);
        else
          live = false;
      }
      cand[b] = c;
      if (c >= 0 && c >= lo_ok && ia - c <= kWindow) okm |= 1u << b;
    }

    int lb, cb;  // best length and its candidate
    if (k >= 4) {
      // Candidates come newest first. Once three rank the full 32 bytes,
      // no later one can outscore them (a tie goes to the newer), so the
      // rest are not compared: they keep the score of a length of 0.
      int score[KMAX];
      int full = 0;
#pragma unroll
      for (int b = 0; b < KMAX; ++b) {
        int ml = 0;
        if (b < k && (okm >> b & 1) && full < 3) {
          ml = equal_bytes_i<0, kRankWords>(wi, win, cand[b] - wbase);
          full += ml == 4 * kRankWords;
        }
        score[b] = (ml << kPosBits) + cand[b];
      }
      int bl = 0, bs = 0, bc = 0;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        // First maximum, then masked to -1 (duplicates of -1 included).
        int best = 0, bv = score[0];
#pragma unroll
        for (int b = 1; b < KMAX; ++b)
          if (b < k && score[b] > bv) {
            bv = score[b];
            best = b;
          }
        int c = 0;
        bool ok = false;
#pragma unroll
        for (int b = 0; b < KMAX; ++b)
          if (b == best) {
            c = cand[b];
            ok = okm >> b & 1;
            score[b] = -1;
          }
        // The rescore on 64 bytes: past a mismatch in the first 32 it is
        // the rank's. A pick whose score was masked (bv < 0) was scored
        // in an earlier round and changes nothing: 0 keeps it so.
        int ml = 0;
        if (ok && bv >= 0) {
          ml = bv >> kPosBits;
          if (ml == 4 * kRankWords)
            ml = equal_bytes_i<kRankWords, kCmpWords>(wi, win, c - wbase);
        }
        ml = min(ml, nrem);
        const int sc = (ml << kPosBits) + c;
        if (t == 0 || sc > bs) {
          bs = sc;
          bl = ml;
          bc = c;
        }
      }
      lb = bl;
      cb = bc;
    } else {
      // Once the best reaches its cap, no later (older) one can beat it.
      const int cap = min(kCmp, nrem);
      int bs = 0;
      lb = 0;
      cb = 0;
#pragma unroll
      for (int b = 0; b < KMAX; ++b) {
        if (b >= k) continue;
        int ml = (okm >> b & 1) && lb < cap
                     ? equal_bytes_i<0, kCmpWords>(wi, win, cand[b] - wbase)
                     : 0;
        ml = min(ml, nrem);
        const int sc = (ml << kPosBits) + cand[b];
        if (b == 0 || sc > bs) {
          bs = sc;
          lb = ml;
          cb = cand[b];
        }
      }
    }
    if (lb == kCmp)
      lb += min(equal_bytes(win, ai + kCmp, cb - wbase + kCmp, kExtWords),
                kExt);
    lb = min(lb, min(nrem, kMaxMatch));
    lbest[o] = lb;
    dbest[o] = ia - cb;

    // min3's candidate: the entry before this position in the 3-byte
    // order (rows G..2G), when its 3-byte hash is this position's.
    int d3 = 0;
    if (min3 && rem >= 3) {
      const int s3 = inv[((size_t)G + g) * N + i];
      if (s3 >= 1) {
        const uint32_t u =
            (uint32_t)sorted[((size_t)G + g) * NA + s3 - 1] ^ kFlip;
        const int c = (int)(u & kPosMask);
        if ((u >> kPosBits) == hash4(wi[0] & 0xFFFFFFu) && c >= lo_ok &&
            ia - c <= kTooFar3 &&
            ((wi[0] ^ word_at(win, c - wbase)) & 0xFFFFFFu) == 0)
          d3 = ia - c;
      }
    }
    if (min3) m3[o] = d3;
  }
}

// Position i's token from the match's scratch (i < N): min3's demotion and
// the lazy rule, which read the best lengths of the next three positions.
// Its length (0 for a literal) and distance.
struct Token {
  int len, dist;
};

__device__ __forceinline__ Token token_at(const int32_t* __restrict__ lb,
                                          const int32_t* __restrict__ db,
                                          const int32_t* __restrict__ m3,
                                          int N, bool min3, bool lazy, int i) {
  // Position j's length after min3's 3-matches (j < N).
  auto after3 = [&](int j, bool& take) {
    const int l = lb[j];
    take = min3 && m3[j] != 0 && l < 4 && !(j + 2 < N && lb[j + 2] >= 4);
    return take ? 3 : l;
  };
  bool take;
  const int l = after3(i, take);
  bool is_m = l >= 4 || take;
  if (lazy && i + 1 < N) {
    bool take1;
    if (after3(i + 1, take1) > l) is_m = false;
  }
  return {is_m ? l : 0, take ? m3[i] : db[i]};
}

// Position p's next position on the walk, from its chunk's start clo (N
// past the block's end).
__device__ __forceinline__ int next_rel(int p, long long n, int N, int len,
                                        int clo) {
  return (p >= n ? N : min(p + max(len, 1), N)) - clo;
}

// Launch 8: chunk blockIdx.x of row blockIdx.y: every position's exit from
// the chunk, written for the chunk's first kEntries positions to `exits`
// as offsets past the chunk's end or kToN.
__global__ void __launch_bounds__(kExitThreads)
k7_exits(int N, const int64_t* __restrict__ n_rows, bool min3, bool lazy,
         const int32_t* __restrict__ lbest, const int32_t* __restrict__ dbest,
         const int32_t* __restrict__ m3, uint16_t* __restrict__ exits) {
  // First the position the walk goes on to, in the chunk, or from kChunk
  // its exit: kChunk + the offset past the chunk's end, kChunk + kToN for
  // N. Then the exits, from the chunk's end back.
  __shared__ int e[kChunk];
  const int g = blockIdx.y, c = blockIdx.x;
  const int clo = c * kChunk, len = min(kChunk, N - clo);
  const long long n = n_rows[g];
  const size_t base = (size_t)g * N;
  for (int t = threadIdx.x; t < len; t += kExitThreads) {
    const Token tok = token_at(lbest + base, dbest + base, m3 + base, N,
                               min3, lazy, clo + t);
    const int q = next_rel(clo + t, n, N, tok.len, clo);
    e[t] = q < len ? q : kChunk + (q + clo >= N ? kToN : q - len);
  }
  __syncthreads();
  // One warp, 32 positions a step: a target past them has its exit
  // already; within them, pointer jumping through shuffles.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int b0 = (len - 1) & ~31; b0 >= 0; b0 -= 32) {
      const int t = b0 + lane;
      int x = t < len ? e[t] : kChunk;
      if (x < kChunk && x >= b0 + 32) x = e[x];
      int j = x < kChunk ? x - b0 : -1;   // the lane the walk goes on to
#pragma unroll
      for (int r = 0; r < 5; ++r) {
        const int from = j < 0 ? lane : j;
        const int jj = __shfl_sync(kAll, j, from);
        const int xx = __shfl_sync(kAll, x, from);
        if (j >= 0) {
          x = xx;
          j = jj;
        }
      }
      if (t < len) e[t] = x;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < min(len, kEntries); t += kExitThreads)
    exits[((size_t)g * gridDim.x + c) * kExitStride + t] =
        (uint16_t)(e[t] - kChunk);
}

// Launch 9: a CTA a row; chunk 0 is entered at 0, chunk c + 1 at chunk c's
// exit from its entry (N once the walk has left the block).
__global__ void __launch_bounds__(kChainThreads)
k7_chain(int N, int nch, const uint16_t* __restrict__ exits,
         int32_t* __restrict__ entry) {
  extern __shared__ uint4 ex4[];
  const uint16_t* ex = reinterpret_cast<const uint16_t*>(ex4);
  const int g = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(
      exits + (size_t)g * nch * kExitStride);
  const int n16 = nch * kExitStride * 2 / 16;
  for (int i = threadIdx.x; i < n16; i += kChainThreads) ex4[i] = src[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int e = 0;
    for (int c = 0; c < nch; ++c) {
      const int clo = c * kChunk, chi = min(clo + kChunk, N);
      entry[(size_t)g * nch + c] = e;
      if (e < chi) {
        const uint16_t x = ex[c * kExitStride + e - clo];
        e = x == kToN ? N : chi + x;
      }
    }
  }
}
static_assert(kExitStride * 2 % 16 == 0, "a chunk's exits are 16-byte rows");

struct Outputs {
  uint8_t* is_tok;
  uint8_t* is_match;
  int64_t* length;
  int64_t* dist;
  int64_t* sym;
  int64_t* len_idx;
  int64_t* dist_idx;
  int64_t* ll_hist;
  int64_t* dist_hist;
};

// Position o's seven outputs (a token when tok, a match of `len` at `d`
// when len > 0), its symbol counted in llh and, for a match, its distance
// code in dh: warp-aggregated shared-memory atomics, so every lane of the
// warp calls it.
__device__ __forceinline__ void emit_position(
    bool in, size_t o, bool tok, int len, int d, int lit,
    const uint8_t* len_tab, const uint8_t* dist_lut, int* llh, int* dh,
    Outputs out) {
  const bool m = tok && len > 0;
  int s = lit, di = 0;
  if (in) {
    if (!m) {
      len = 0;
      d = 1;
    }
    int li = 0;
    if (len_tab != nullptr) {
      li = len_tab[min(max(len - 3, 0), 255)];
      const int d1 = d - 1;
      di = d <= 256 ? dist_lut[min(max(d1, 0), 255)]
                    : dist_lut[min(max(256 + (d1 >> 7), 0), 511)];
      if (m) s = 257 + li;
    }
    out.is_tok[o] = tok;
    out.is_match[o] = m;
    out.length[o] = len;
    out.dist[o] = d;
    out.sym[o] = s;
    out.len_idx[o] = li;
    out.dist_idx[o] = di;
  }
  count_digit(llh, tok, s);
  count_digit(dh, m, di);
}

// Launch 10: chunk blockIdx.x of row blockIdx.y: the tokens, the
// positions the walk visits from the chunk's entry, then every position's
// outputs, and the chunk's histograms added to the row's (zeroed by
// k7_count).
__global__ void __launch_bounds__(kEmitThreads)
k7_emit(const uint8_t* __restrict__ data, int D, int hist, int N,
        const int64_t* __restrict__ n_rows, bool min3, bool lazy,
        const int32_t* __restrict__ lbest, const int32_t* __restrict__ dbest,
        const int32_t* __restrict__ m3, const int32_t* __restrict__ entry,
        const int64_t* __restrict__ len_tab,
        const int64_t* __restrict__ dist_lut, Outputs out) {
  __shared__ int16_t tl[kChunk];   // token lengths, 0 for a literal
  __shared__ int td[kChunk];       // token distances
  // A bit a position, a word 32 positions: the walk steps to the next
  // position (lit); the walk visits the position (vis).
  __shared__ uint32_t lit[kChunk / 32], vis[kChunk / 32];
  __shared__ int llh[kLitlen], dh[kDistSyms];
  __shared__ uint8_t ltab[256], dtab[512];  // len_tab and dist_lut
  const int g = blockIdx.y, c = blockIdx.x, lane = threadIdx.x & 31;
  const int clo = c * kChunk, len = min(kChunk, N - clo);
  const long long n = n_rows[g];
  const size_t base = (size_t)g * N;
  for (int j = threadIdx.x; j < kLitlen; j += kEmitThreads) llh[j] = 0;
  for (int j = threadIdx.x; j < kDistSyms; j += kEmitThreads) dh[j] = 0;
  for (int j = threadIdx.x; j < 512; j += kEmitThreads) {
    if (j < 256) ltab[j] = (uint8_t)len_tab[j];
    dtab[j] = (uint8_t)dist_lut[j];
  }
  // A warp 32 positions at a time; every load first.
  constexpr int kPer = kChunk / kEmitThreads;
  const int first = threadIdx.x & ~31;
  Token tok[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int t = first + k * kEmitThreads + lane;
    tok[k] = t < len ? token_at(lbest + base, dbest + base, m3 + base, N,
                                min3, lazy, clo + t)
                     : Token{0, 1};
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b0 = first + k * kEmitThreads, t = b0 + lane;
    bool step1 = true;  // past the chunk's end: the walk runs off it
    if (t < len) {
      tl[t] = (int16_t)tok[k].len;
      td[t] = tok[k].dist;
      step1 = next_rel(clo + t, n, N, tok[k].len, clo) == t + 1;
    }
    const unsigned steps = __ballot_sync(kAll, step1);
    if (lane == 0 && b0 < len) {
      lit[b0 >> 5] = steps;
      vis[b0 >> 5] = 0;
    }
  }
  __syncthreads();
  // The walk, one thread: a run of steps to the next position a word at a
  // time, a match (or a position at or past n) a step.
  if (threadIdx.x == 0) {
    int p = entry[(size_t)g * gridDim.x + c] - clo;
    int at = -1;
    uint32_t steps = 0, seen = 0;
    while (p < len) {
      const int w = p >> 5, bit = p & 31;
      if (w != at) {
        if (at >= 0) vis[at] = seen;
        at = w;
        steps = lit[w];
        seen = 0;
      }
      const uint32_t stop = ~(steps >> bit);  // ones past the word's end
      const int run = stop ? __ffs(stop) - 1 : 32;
      if (bit + run >= 32) {  // steps of one to the word's end
        seen |= ~0u << bit;
        p = (w + 1) << 5;
      } else {                // p .. p + run, then p + run's step
        seen |= ((2u << run) - 1) << bit;
        p = next_rel(clo + p + run, n, N, tl[p + run], clo);
      }
    }
    if (at >= 0) vis[at] = seen;
  }
  __syncthreads();
  const uint8_t* lits = data + (size_t)g * D + hist + clo;
  for (int b0 = first; b0 < len; b0 += kEmitThreads) {
    const int t = b0 + lane;
    const bool in = t < len;
    emit_position(in, base + clo + t,
                  in && clo + t < n && (vis[b0 >> 5] >> lane & 1),
                  in ? tl[t] : 0, in ? td[t] : 1, in ? lits[t] : 0, ltab,
                  dtab, llh, dh, out);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kLitlen; j += kEmitThreads)
    if (llh[j])
      atomicAdd(reinterpret_cast<unsigned long long*>(
                    &out.ll_hist[(size_t)g * kLitlen + j]),
                (unsigned long long)llh[j]);
  for (int j = threadIdx.x; j < kDistSyms; j += kEmitThreads)
    if (dh[j])
      atomicAdd(reinterpret_cast<unsigned long long*>(
                    &out.dist_hist[(size_t)g * kDistSyms + j]),
                (unsigned long long)dh[j]);
}

// lits_only (level -2): every position < n a literal, a CTA a row.
__global__ void __launch_bounds__(kChunk)
k7_literals(const uint8_t* __restrict__ data, int D, int hist, int N,
            const int64_t* __restrict__ n_rows, Outputs out) {
  __shared__ int llh[kLitlen], dh[kDistSyms];
  const int g = blockIdx.x, t = threadIdx.x;
  const long long n = n_rows[g];
  for (int j = t; j < kLitlen; j += kChunk) llh[j] = 0;
  for (int j = t; j < kDistSyms; j += kChunk) dh[j] = 0;
  __syncthreads();
  const uint8_t* lit = data + (size_t)g * D + hist;
  for (int base = 0; base < N; base += kChunk) {
    const int i = base + t;
    const bool in = i < N;
    emit_position(in, (size_t)g * N + i, in && i < n, 0, 1, in ? lit[i] : 0,
                  nullptr, nullptr, llh, dh, out);
  }
  __syncthreads();
  for (int j = t; j < kLitlen; j += kChunk)
    out.ll_hist[(size_t)g * kLitlen + j] = llh[j] + (j == 256);
  for (int j = t; j < kDistSyms; j += kChunk)
    out.dist_hist[(size_t)g * kDistSyms + j] = dh[j];
}

}  // namespace

extern "C" {

// The pointers of the entry points, in ops/match_kernels.py's order. Rows
// are contiguous. data (G, D) uint8; n, hist_len (G,) int64; R = 2G under
// min3, else G: low, sorted (R, NA) int32 (the keys after the low pass and
// after both), inv (R, N) int32, tiles (R, nt, 256)
// int32; lbest, dbest, m3 (G, N) int32; exits (G, nch, 264) uint16, entry
// (G, nch) int32; len_tab (256,), dist_lut (512,) int64; the outputs:
// is_tok, is_match (G, N) bool; length, dist, sym, len_idx, dist_idx (G, N)
// int64; ll_hist (G, 286), dist_hist (G, 30) int64.
struct MatchArgs {
  const void* data;
  const void* n;
  const void* hist_len;
  void* low;
  void* sorted;
  void* inv;
  void* tiles;
  void* lbest;
  void* dbest;
  void* m3;
  void* exits;
  void* entry;
  const void* len_tab;
  const void* dist_lut;
  void* is_tok;
  void* is_match;
  void* length;
  void* dist;
  void* sym;
  void* len_idx;
  void* dist_idx;
  void* ll_hist;
  void* dist_hist;
};

}  // extern "C"

namespace {

// Launches 1-6 on s: the sorted keys of every key row in a->sorted (a->low
// holds the low pass's output) and inv.
cudaError_t sort_keys(const MatchArgs* a, int G, int D, int hist, bool min3,
                      cudaStream_t s, int* launched) {
  const int NA = D - kPad, R = (min3 ? 2 : 1) * G;
  const int nt = blocks_for(NA, kSortTile);
  const uint8_t* data = (const uint8_t*)a->data;
  int32_t* low = (int32_t*)a->low;
  int32_t* tiles = (int32_t*)a->tiles;
  const dim3 grid(nt, R);
  cudaError_t err;
  k7_count<<<grid, kSortThreads, 0, s>>>(data, D, G, NA, nt, tiles,
                                         (int64_t*)a->ll_hist,
                                         (int64_t*)a->dist_hist);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k7_scan<<<R, kDigits, 0, s>>>(nt, tiles);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k7_scatter<0><<<grid, kSortThreads, 0, s>>>(data, D, G, hist, nullptr, NA,
                                              nt, tiles, low, nullptr);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k7_hist<<<grid, kSortThreads, 0, s>>>(low, NA, nt, tiles);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k7_scan<<<R, kDigits, 0, s>>>(nt, tiles);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k7_scatter<1><<<grid, kSortThreads, 0, s>>>(data, D, G, hist, low, NA, nt,
                                              tiles, (int32_t*)a->sorted,
                                              (int32_t*)a->inv);
  ++*launched;
  return cudaGetLastError();
}

bool shape_ok(int G, int D, int hist) {
  const int NA = D - kPad;
  return G > 0 && 2 * G <= 65535 && hist >= 0 && NA - hist >= 1 &&
         NA <= (1 << kPosBits);
}

}  // namespace

extern "C" {

// The sort alone (launches 1-6), for checks against the plain version's.
int zt_match_sort(const MatchArgs* a, int G, int D, int hist, int min3,
                  void* stream, int device, int* launched) {
  *launched = 0;
  if (!shape_ok(G, D, hist)) return (int)cudaErrorInvalidValue;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  return (int)sort_keys(a, G, D, hist, min3 != 0, (cudaStream_t)stream,
                        launched);
}

// A group's tokens: launches 1-10.
int zt_match_tokens(const MatchArgs* a, int G, int D, int hist, int k,
                    int lazy, int min3, void* stream, int device,
                    int* launched) {
  *launched = 0;
  if (!shape_ok(G, D, hist) || k < 1 || k > 32)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int NA = D - kPad, N = NA - hist;
  const uint8_t* data = (const uint8_t*)a->data;
  const int64_t* n = (const int64_t*)a->n;
  if ((err = sort_keys(a, G, D, hist, min3 != 0, s, launched)) !=
      cudaSuccess)
    return (int)err;

  const dim3 mgrid(blocks_for(N, kSpan), G);
#define ZT_MATCH(KMAX)                                                     \
  k7_match<KMAX><<<mgrid, kThreads, 0, s>>>(                               \
      data, D, hist, N, n, (const int64_t*)a->hist_len,                    \
      (const int32_t*)a->sorted, (const int32_t*)a->inv, k, min3 != 0,     \
      (int32_t*)a->lbest, (int32_t*)a->dbest, (int32_t*)a->m3)
  if (k <= 2)
    ZT_MATCH(2);
  else if (k <= 4)
    ZT_MATCH(4);
  else if (k <= 12)
    ZT_MATCH(12);
  else if (k <= 16)
    ZT_MATCH(16);
  else
    ZT_MATCH(32);
#undef ZT_MATCH
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int nch = blocks_for(N, kChunk);
  const int32_t* lbest = (const int32_t*)a->lbest;
  const int32_t* dbest = (const int32_t*)a->dbest;
  const int32_t* m3 = (const int32_t*)a->m3;
  k7_exits<<<dim3(nch, G), kExitThreads, 0, s>>>(
      N, n, min3 != 0, lazy != 0, lbest, dbest, m3, (uint16_t*)a->exits);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int csmem = nch * kExitStride * 2;
  if ((err = cudaFuncSetAttribute(k7_chain,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  csmem)) != cudaSuccess)
    return (int)err;
  k7_chain<<<G, kChainThreads, csmem, s>>>(
      N, nch, (const uint16_t*)a->exits, (int32_t*)a->entry);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const Outputs out{(uint8_t*)a->is_tok,  (uint8_t*)a->is_match,
                    (int64_t*)a->length,  (int64_t*)a->dist,
                    (int64_t*)a->sym,     (int64_t*)a->len_idx,
                    (int64_t*)a->dist_idx, (int64_t*)a->ll_hist,
                    (int64_t*)a->dist_hist};
  k7_emit<<<dim3(nch, G), kEmitThreads, 0, s>>>(
      data, D, hist, N, n, min3 != 0, lazy != 0, lbest, dbest, m3,
      (const int32_t*)a->entry, (const int64_t*)a->len_tab,
      (const int64_t*)a->dist_lut, out);
  ++*launched;
  return (int)cudaGetLastError();
}

// lits_only (level -2): every position < n a literal, one launch.
int zt_match_literals(const MatchArgs* a, int G, int D, int hist,
                      void* stream, int device, int* launched) {
  *launched = 0;
  if (!shape_ok(G, D, hist)) return (int)cudaErrorInvalidValue;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const int N = D - kPad - hist;
  const Outputs out{(uint8_t*)a->is_tok,  (uint8_t*)a->is_match,
                    (int64_t*)a->length,  (int64_t*)a->dist,
                    (int64_t*)a->sym,     (int64_t*)a->len_idx,
                    (int64_t*)a->dist_idx, (int64_t*)a->ll_hist,
                    (int64_t*)a->dist_hist};
  k7_literals<<<G, kChunk, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a->data, D, hist, N, (const int64_t*)a->n, out);
  ++*launched;
  return (int)cudaGetLastError();
}

}  // extern "C"
