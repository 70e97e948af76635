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
// more (gigabytes a group); here a CTA stages the 34 KB of its row that its
// positions can reach (32 KiB back, PAD ahead) in shared memory once and
// compares words in place, so nothing but a few int32 per position reaches
// device memory.
//
// Design, five launches a group (k7_literals alone under lits_only),
// with the sort between the first two left to the wrapper (torch.sort of
// the keys: ROADMAP B3 queues a hand-written one):
//   1. k7_keys: every position's key, and its 3-byte key under min3;
//   2. k7_rank: from the sorted keys, each position's index in the order
//      (its candidates are the entries just before it) and, under min3, its
//      3-gram candidate;
//   3. k7_match: one thread a position, 1024 positions a CTA, the row's
//      bytes from 32 KiB before the CTA's first position to PAD past its
//      last in shared memory: the candidates, the ranking, the rescoring,
//      the extension and the min3 test; the position's best length and
//      distance and its 3-gram distance (0: none) go to scratch;
//   4. k7_select: min3's demotion and the lazy rule, which read the best
//      lengths of the next three positions: each position's final match
//      length (0 for a literal) and distance;
//   5. k7_cover: one CTA of 1024 threads a row. The row is cut into chunks
//      of 512 positions (>= 258, so a step from a chunk lands in the next
//      one, or at N past the block's end). Three passes of fixed length,
//      whatever the data: a thread a chunk scans it backward, giving every
//      position its exit from the chunk (a step's target when that leaves
//      the chunk, else the target's exit; a ring of the last 258 exits in
//      shared memory holds every one the scan reads, and at its end the
//      exits from the 258 entries the chunk can have); one thread chains
//      the chunks' entries from position 0, a shared-memory lookup a
//      chunk; a thread a chunk scans it forward from its entry, marking
//      the positions the walk visits in a shared bitmap. Both scans read
//      each position's length once, in batches, and never a load that
//      waits on the walk. Then every thread writes its positions' seven
//      outputs and counts its tokens in shared histograms
//      (warp-aggregated), which the CTA writes as int64.
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
// order the unsigned order, so torch sorts them as int32.
constexpr uint32_t kFlip = 0x80000000u;

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kSpan = kThreads * kPerThread;   // positions of a match CTA
// A match CTA's bytes: 32 KiB before its first position (aligned down to a
// word), its span and PAD after it, and two words that a funnel read past
// the last needed byte may touch.
constexpr int kWinWords = (kWindow + 4 + kSpan + kPad) / 4 + 2;

constexpr int kCoverThreads = 1024;
constexpr int kChunk = 512;        // >= kMaxMatch
constexpr int kMaxNA = 1 << kPosBits;
constexpr int kMaxChunks = kMaxNA / kChunk;
// A chunk's exits, a ring of the last kRing in the backward scan: a step is
// at most kMaxMatch, and a chunk is entered at most kMaxMatch - 1 past its
// start. An exit is kept as its offset past the chunk's end (< kMaxMatch),
// or kToN for N.
constexpr int kRing = kMaxMatch;
constexpr uint16_t kToN = 0xFFFF;
constexpr int kBatch = 16;         // lengths a scan loads ahead
constexpr int kLitlen = 286, kDistSyms = 30;
constexpr unsigned kAll = 0xffffffffu;

int blocks_for(long long n, int per) { return (int)((n + per - 1) / per); }

__device__ __forceinline__ uint32_t hash4(uint32_t v) {
  return (v * kHashMul) >> kHashShift;
}

// The little-endian word of the 4 bytes at byte offset `off` of `win`.
__device__ __forceinline__ uint32_t word_at(const uint32_t* win, int off) {
  return __funnelshift_r(win[off >> 2], win[(off >> 2) + 1], (off & 3) * 8);
}

// Equal leading bytes of the words at a and b from word w0 up to w1 (the
// earlier words known equal); 4 * w1 when all are equal.
__device__ __forceinline__ int equal_bytes(const uint32_t* win, int a, int b,
                                           int w0, int w1) {
  for (int w = w0; w < w1; ++w) {
    const uint32_t x = word_at(win, a + 4 * w) ^ word_at(win, b + 4 * w);
    if (x) return 4 * w + ((__ffs(x) - 1) >> 3);
  }
  return 4 * w1;
}

// The same against the i side's first 16 words, held in registers.
template <int W0, int W1>
__device__ __forceinline__ int equal_bytes_i(const uint32_t (&wi)[kCmpWords],
                                             const uint32_t* win, int b) {
#pragma unroll
  for (int w = W0; w < W1; ++w) {
    const uint32_t x = wi[w] ^ word_at(win, b + 4 * w);
    if (x) return 4 * w + ((__ffs(x) - 1) >> 3);
  }
  return 4 * W1;
}

__global__ void __launch_bounds__(kThreads)
k7_keys(const uint8_t* __restrict__ data, int D, int NA, int G, bool min3,
        int32_t* __restrict__ keys) {
  const int g = blockIdx.y;
  const int p = (int)(blockIdx.x * kThreads + threadIdx.x);
  if (p >= NA) return;
  const uint8_t* row = data + (size_t)g * D;
  const uint32_t v = (uint32_t)row[p] | (uint32_t)row[p + 1] << 8 |
                     (uint32_t)row[p + 2] << 16 | (uint32_t)row[p + 3] << 24;
  keys[(size_t)g * NA + p] = (int32_t)((hash4(v) << kPosBits | p) ^ kFlip);
  if (min3)
    keys[((size_t)G + g) * NA + p] =
        (int32_t)((hash4(v & 0xFFFFFFu) << kPosBits | p) ^ kFlip);
}

__global__ void __launch_bounds__(kThreads)
k7_rank(const int32_t* __restrict__ sorted, int NA, int G, bool min3,
        int32_t* __restrict__ inv, int32_t* __restrict__ c3) {
  const int g = blockIdx.y;
  const int s = (int)(blockIdx.x * kThreads + threadIdx.x);
  if (s >= NA) return;
  const int32_t* row = sorted + (size_t)g * NA;
  const uint32_t u = (uint32_t)row[s] ^ kFlip;
  inv[(size_t)g * NA + (u & kPosMask)] = s;
  if (min3) {
    const int32_t* row3 = sorted + ((size_t)G + g) * NA;
    const uint32_t u3 = (uint32_t)row3[s] ^ kFlip;
    int c = -1;
    if (s >= 1) {
      const uint32_t prev = (uint32_t)row3[s - 1] ^ kFlip;
      if ((prev >> kPosBits) == (u3 >> kPosBits)) c = (int)(prev & kPosMask);
    }
    c3[(size_t)g * NA + (u3 & kPosMask)] = c;
  }
}

// One thread a position, KMAX >= k candidates held in registers.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
k7_match(const uint8_t* __restrict__ data, int D, int hist, int N,
         const int64_t* __restrict__ n_rows,
         const int64_t* __restrict__ hist_len_rows,
         const int32_t* __restrict__ sorted, const int32_t* __restrict__ inv,
         const int32_t* __restrict__ c3, int k, bool min3,
         int32_t* __restrict__ lbest, int32_t* __restrict__ dbest,
         int32_t* __restrict__ m3) {
  __shared__ uint32_t win[kWinWords];
  const int g = blockIdx.y;
  const int i0 = blockIdx.x * kSpan;
  const int NA = hist + N;
  const uint8_t* row = data + (size_t)g * D;
  const long long n = n_rows[g];
  const long long lo_ok = (long long)hist - hist_len_rows[g];

  // Stage bytes [ws, we) of the row; zeros past we.
  int ws = hist + i0 - kWindow;
  ws = ws < 0 ? 0 : ws & ~3;
  const int we = min(D, hist + i0 + kSpan + kPad);
  for (int w = threadIdx.x; w < kWinWords; w += kThreads) {
    uint32_t x = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = ws + 4 * w + b;
      if (p < we) x |= (uint32_t)row[p] << (8 * b);
    }
    win[w] = x;
  }
  __syncthreads();

  const int32_t* srow = sorted + (size_t)g * NA;
  for (int r = 0; r < kPerThread; ++r) {
    const int i = i0 + r * kThreads + (int)threadIdx.x;
    if (i >= N) break;
    const size_t o = (size_t)g * N + i;
    const long long rem = n - i;
    if (rem <= 0) {  // past the block's end every length is 0
      lbest[o] = 0;
      dbest[o] = 0;
      m3[o] = 0;
      continue;
    }
    const int nrem = rem > (1 << 20) ? (1 << 20) : (int)rem;
    const int ia = hist + i;
    const int ai = ia - ws;
    uint32_t wi[kCmpWords];
#pragma unroll
    for (int w = 0; w < kCmpWords; ++w) wi[w] = word_at(win, ai + 4 * w);
    const uint32_t h = hash4(wi[0]);

    // The candidates: the entries before this position in the sorted
    // order, while their hash is this position's.
    const int s = inv[(size_t)g * NA + ia];
    int cand[KMAX];
    uint32_t okm = 0;
    bool live = true;
#pragma unroll
    for (int b = 0; b < KMAX; ++b) {
      int c = -1;
      if (b < k && live && s - 1 - b >= 0) {
        const uint32_t u = (uint32_t)srow[s - 1 - b] ^ kFlip;
        if ((u >> kPosBits) == h)
          c = (int)(u & kPosMask);
        else
          live = false;
      }
      cand[b] = c;
      if (c >= 0 && c >= lo_ok && ia - c <= kWindow) okm |= 1u << b;
    }

    int lb, cb;  // best length and its candidate
    if (k >= 4) {
      int score[KMAX];
#pragma unroll
      for (int b = 0; b < KMAX; ++b) {
        int ml = 0;
        if (b < k && (okm >> b & 1))
          ml = equal_bytes_i<0, kRankWords>(wi, win, cand[b] - ws);
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
        int ml = ok ? equal_bytes_i<0, kCmpWords>(wi, win, c - ws) : 0;
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
      int bs = 0;
      lb = 0;
      cb = 0;
#pragma unroll
      for (int b = 0; b < KMAX; ++b) {
        if (b >= k) continue;
        int ml = (okm >> b & 1)
                     ? equal_bytes_i<0, kCmpWords>(wi, win, cand[b] - ws)
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
      lb += min(equal_bytes(win, ai + kCmp, cb - ws + kCmp, 0, kExtWords),
                kExt);
    lb = min(lb, min(nrem, kMaxMatch));
    lbest[o] = lb;
    dbest[o] = ia - cb;

    int d3 = 0;
    if (min3 && rem >= 3) {
      const int c = c3[(size_t)g * NA + ia];
      if (c >= 0 && c >= lo_ok && ia - c <= kTooFar3 &&
          ((wi[0] ^ word_at(win, c - ws)) & 0xFFFFFFu) == 0)
        d3 = ia - c;
    }
    m3[o] = d3;
  }
}

// min3's demotion and the lazy rule: each position's match length (0 for a
// literal) and distance.
__global__ void __launch_bounds__(kThreads)
k7_select(int N, bool min3, bool lazy, const int32_t* __restrict__ lbest,
          const int32_t* __restrict__ dbest, const int32_t* __restrict__ m3,
          int32_t* __restrict__ tlen, int32_t* __restrict__ tdist) {
  const int g = blockIdx.y;
  const int i = (int)(blockIdx.x * kThreads + threadIdx.x);
  if (i >= N) return;
  const size_t base = (size_t)g * N;
  const int32_t* lb = lbest + base;
  // Position j's length after min3's 3-matches (j < N).
  auto after3 = [&](int j, bool& take) {
    const int l = lb[j];
    take = min3 && m3[base + j] != 0 && l < 4 && !(j + 2 < N && lb[j + 2] >= 4);
    return take ? 3 : l;
  };
  bool take;
  const int l = after3(i, take);
  bool is_m = l >= 4 || take;
  if (lazy && i + 1 < N) {
    bool take1;
    if (after3(i + 1, take1) > l) is_m = false;
  }
  tlen[base + i] = is_m ? l : 0;
  tdist[base + i] = take ? m3[base + i] : dbest[base + i];
}

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

// Row g's outputs and histograms from its cover bitmap (or, under
// lits_only, every position < n a literal). Called by all the CTA's
// threads.
__device__ void emit_row(const uint8_t* __restrict__ data, int D, int hist,
                         int N, int g, long long n, bool lits_only,
                         const uint32_t* reach,
                         const int32_t* __restrict__ tlen,
                         const int32_t* __restrict__ tdist,
                         const int64_t* __restrict__ len_tab,
                         const int64_t* __restrict__ dist_lut, int* llh,
                         int* dh, const Outputs& out) {
  const int t = threadIdx.x;
  const unsigned lane = t & 31;
  const uint8_t* lit = data + (size_t)g * D + hist;
  for (int base = 0; base < N; base += kCoverThreads) {
    const int i = base + t;
    bool tok = false, m = false;
    int s = 0, di = 0;
    if (i < N) {
      const size_t o = (size_t)g * N + i;
      s = lit[i];
      int len = 0, d = 1, li = 0;
      if (lits_only) {
        tok = i < n;
      } else {
        tok = i < n && (reach[i >> 5] >> (i & 31) & 1);
        const int l = tlen[o];
        m = tok && l > 0;
        if (m) {
          len = l;
          d = tdist[o];
        }
        li = (int)len_tab[min(max(len - 3, 0), 255)];
        const int d1 = d - 1;
        di = (int)(d <= 256 ? dist_lut[min(max(d1, 0), 255)]
                            : dist_lut[min(max(256 + (d1 >> 7), 0), 511)]);
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
    const unsigned toks = __ballot_sync(kAll, tok);
    if (tok) {
      const unsigned same = __match_any_sync(toks, s);
      if (lane == (unsigned)(__ffs(same) - 1)) atomicAdd(&llh[s], __popc(same));
    }
    const unsigned ms = __ballot_sync(kAll, m);
    if (m) {
      const unsigned same = __match_any_sync(ms, di);
      if (lane == (unsigned)(__ffs(same) - 1)) atomicAdd(&dh[di], __popc(same));
    }
  }
  __syncthreads();
  for (int j = t; j < kLitlen; j += kCoverThreads)
    out.ll_hist[(size_t)g * kLitlen + j] = llh[j] + (j == 256);
  for (int j = t; j < kDistSyms; j += kCoverThreads)
    out.dist_hist[(size_t)g * kDistSyms + j] = dh[j];
}

// k7_cover's dynamic shared memory for blocks of N positions: the chunks'
// exit rings, which the bitmap of visited positions then reuses.
static_assert(kRing * sizeof(uint16_t) >= kChunk / 8,
              "a chunk's bitmap words fit in its ring");
int cover_smem(int N) {
  const int nch = (N + kChunk - 1) / kChunk;
  return (kRing * nch * (int)sizeof(uint16_t) + 3) & ~3;
}

__global__ void __launch_bounds__(kCoverThreads)
k7_cover(const uint8_t* __restrict__ data, int D, int hist, int N,
         const int64_t* __restrict__ n_rows, const int32_t* __restrict__ tlen,
         const int32_t* __restrict__ tdist,
         const int64_t* __restrict__ len_tab,
         const int64_t* __restrict__ dist_lut, Outputs out) {
  extern __shared__ uint32_t smem[];
  __shared__ int entry[kMaxChunks];
  __shared__ int llh[kLitlen], dh[kDistSyms];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const long long n = n_rows[g];
  const int nch = (N + kChunk - 1) / kChunk;
  for (int j = t; j < kLitlen; j += kCoverThreads) llh[j] = 0;
  for (int j = t; j < kDistSyms; j += kCoverThreads) dh[j] = 0;
  const int32_t* tl = tlen + (size_t)g * N;
  // The walk's step from p: its token's length or 1; N from p >= n.
  auto next = [&](int p, int l) {
    return p >= n ? N : min(p + max(l, 1), N);
  };
  const int lo = t * kChunk, hi = min(lo + kChunk, N);

  // Pass 1: each position's exit from its chunk, p from hi - 1 down.
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  if (t < nch) {
    for (int b = hi; b > lo; b -= kBatch) {
      int l[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) l[u] = b - 1 - u >= lo ? tl[b - 1 - u] : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = b - 1 - u;
        if (p < lo) break;
        const int q = next(p, l[u]);
        const uint16_t e =
            q >= hi ? (q >= N ? kToN : (uint16_t)(q - hi))
                    : ring[((q - lo) % kRing) * nch + t];
        ring[((p - lo) % kRing) * nch + t] = e;
      }
    }
  }
  __syncthreads();

  // Pass 2: chunk 0 is entered at 0, chunk c + 1 at chunk c's exit from
  // its entry (N once the walk has left the block).
  if (t == 0) {
    int e = 0;
    for (int c = 0; c < nch; ++c) {
      const int clo = c * kChunk, chi = min(clo + kChunk, N);
      entry[c] = e;
      if (e < chi) {
        const uint16_t x = ring[((e - clo) % kRing) * nch + c];
        e = x == kToN ? N : chi + x;
      }
    }
  }
  __syncthreads();

  // Pass 3: mark the walk's positions in each chunk, scanning forward.
  uint32_t* reach = smem;
  if (t < nch) {
    for (int w = lo >> 5; w < (hi + 31) >> 5; ++w) reach[w] = 0;
    int at = entry[t];
    for (int b = lo; b < hi && at < hi; b += kBatch) {
      int l[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) l[u] = b + u < hi ? tl[b + u] : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = b + u;
        if (p == at && p < hi) {
          reach[p >> 5] |= 1u << (p & 31);
          at = next(p, l[u]);
        }
      }
    }
  }
  __syncthreads();
  emit_row(data, D, hist, N, g, n, false, reach, tlen, tdist, len_tab,
           dist_lut, llh, dh, out);
}

__global__ void __launch_bounds__(kCoverThreads)
k7_literals(const uint8_t* __restrict__ data, int D, int hist, int N,
            const int64_t* __restrict__ n_rows, Outputs out) {
  __shared__ int llh[kLitlen], dh[kDistSyms];
  const int t = threadIdx.x;
  for (int j = t; j < kLitlen; j += kCoverThreads) llh[j] = 0;
  for (int j = t; j < kDistSyms; j += kCoverThreads) dh[j] = 0;
  __syncthreads();
  emit_row(data, D, hist, N, blockIdx.x, n_rows[blockIdx.x], true, nullptr,
           nullptr, nullptr, nullptr, nullptr, llh, dh, out);
}

}  // namespace

extern "C" {

// The pointers of zt_match_tokens and zt_match_literals, in
// ops/match_kernels.py's order. Rows are contiguous: data (G, D) uint8;
// n, hist_len (G,) int64; keys and sorted ((2 if min3 else 1) G, NA)
// int32; inv, c3 (G, NA) int32; lbest, dbest, m3, tlen, tdist (G, N)
// int32 scratch; len_tab (256,), dist_lut (512,) int64; the outputs: is_tok,
// is_match (G, N) bool; length, dist, sym, len_idx, dist_idx (G, N) int64;
// ll_hist (G, 286), dist_hist (G, 30) int64.
struct MatchArgs {
  const void* data;
  const void* n;
  const void* hist_len;
  void* keys;
  const void* sorted;
  void* inv;
  void* c3;
  void* lbest;
  void* dbest;
  void* m3;
  void* tlen;
  void* tdist;
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

// Launch 1: the sort keys (and the 3-byte keys under min3, rows G .. 2G).
int zt_match_keys(const MatchArgs* a, int G, int D, int min3, void* stream,
                  int device, int* launched) {
  *launched = 0;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const int NA = D - kPad;
  k7_keys<<<dim3(blocks_for(NA, kThreads), G), kThreads, 0,
            (cudaStream_t)stream>>>((const uint8_t*)a->data, D, NA, G,
                                    min3 != 0, (int32_t*)a->keys);
  ++*launched;
  return (int)cudaGetLastError();
}

// Launches 2-5, after the caller sorted each row of keys.
int zt_match_tokens(const MatchArgs* a, int G, int D, int hist, int k,
                    int lazy, int min3, void* stream, int device,
                    int* launched) {
  *launched = 0;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int NA = D - kPad, N = NA - hist;
  const uint8_t* data = (const uint8_t*)a->data;
  const int64_t* n = (const int64_t*)a->n;

  k7_rank<<<dim3(blocks_for(NA, kThreads), G), kThreads, 0, s>>>(
      (const int32_t*)a->sorted, NA, G, min3 != 0, (int32_t*)a->inv,
      (int32_t*)a->c3);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const dim3 mgrid(blocks_for(N, kSpan), G);
#define ZT_MATCH(KMAX)                                                     \
  k7_match<KMAX><<<mgrid, kThreads, 0, s>>>(                               \
      data, D, hist, N, n, (const int64_t*)a->hist_len,                    \
      (const int32_t*)a->sorted, (const int32_t*)a->inv,                   \
      (const int32_t*)a->c3, k, min3 != 0, (int32_t*)a->lbest,             \
      (int32_t*)a->dbest, (int32_t*)a->m3)
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

  k7_select<<<dim3(blocks_for(N, kThreads), G), kThreads, 0, s>>>(
      N, min3 != 0, lazy != 0, (const int32_t*)a->lbest,
      (const int32_t*)a->dbest, (const int32_t*)a->m3, (int32_t*)a->tlen,
      (int32_t*)a->tdist);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const Outputs out{(uint8_t*)a->is_tok,  (uint8_t*)a->is_match,
                    (int64_t*)a->length,  (int64_t*)a->dist,
                    (int64_t*)a->sym,     (int64_t*)a->len_idx,
                    (int64_t*)a->dist_idx, (int64_t*)a->ll_hist,
                    (int64_t*)a->dist_hist};
  const int smem = cover_smem(N);
  if ((err = cudaFuncSetAttribute(k7_cover,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  k7_cover<<<G, kCoverThreads, smem, s>>>(
      data, D, hist, N, n, (const int32_t*)a->tlen,
      (const int32_t*)a->tdist, (const int64_t*)a->len_tab,
      (const int64_t*)a->dist_lut, out);
  ++*launched;
  return (int)cudaGetLastError();
}

// lits_only (level -2): every position < n a literal, one launch.
int zt_match_literals(const MatchArgs* a, int G, int D, int hist,
                      void* stream, int device, int* launched) {
  *launched = 0;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const int N = D - kPad - hist;
  const Outputs out{(uint8_t*)a->is_tok,  (uint8_t*)a->is_match,
                    (int64_t*)a->length,  (int64_t*)a->dist,
                    (int64_t*)a->sym,     (int64_t*)a->len_idx,
                    (int64_t*)a->dist_idx, (int64_t*)a->ll_hist,
                    (int64_t*)a->dist_hist};
  k7_literals<<<G, kCoverThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a->data, D, hist, N, (const int64_t*)a->n, out);
  ++*launched;
  return (int)cudaGetLastError();
}

}  // extern "C"
