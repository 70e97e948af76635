// Hand-written Hopper (sm_90a) kernel for the encoder's Huffman tables.
//
// Built by zippy_tpu_torch/ops/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (never --use_fast_math) and bound through ctypes: the entry point takes raw
// device pointers and the caller's stream, launches one kernel, allocates
// nothing, and returns the first CUDA error it met (0 when the launch was
// accepted).
//
// K5 zt_huffman_tables replaces the XLA code of zippy_tpu's encode_block
//    between find_tokens and pack_tokens (zippy_tpu/ops/deflate_device.py):
//    `_kraft_lengths` (:464) for the litlen, distance and code-length codes,
//    `_header_stats_device` (:596), `_rev_codes_device` (:582) and the
//    stored/fixed/dynamic choice (:676-700). In the port its plain version
//    is deflate_device.huffman_tables_plain, whose torch ops it equals
//    element for element. One launch serves a group; a CTA builds one row
//    (block) from its ll_hist (286), dist_hist (30) and n, and writes the
//    row's ll_lens, d_lens, cl_lens, mode, use_ll, ll_codes, use_d and
//    d_codes (int64, the plain version's shapes).
//
//    Bound: neither bytes (about 10 KB a row) nor operations (a few hundred
//    thousand a row): the launch, and then the chain of dependent passes
//    inside a row (30 bisection steps, up to 2 * (15 + 15 + 34) repair
//    passes, each a sort, a scan or a reduction). The torch version issued
//    each pass as separate launches, about 13,400 a group with the card
//    mostly idle.
//    Design: one CTA a row (kRowsPerCta), its warps in groups that each
//    synchronize alone, with __syncwarp or a named barrier (bar.sync id,
//    n), never a barrier of the whole CTA:
//    - group A, kLLWarps warps: the litlen code's candidate (a), the
//      bisected water-filling, and its repair;
//    - group B, kLLWarps warps, beside it: candidate (b), nearest
//      rounding, and its repair; it hands its lengths and cost to A
//      (barrier kBarAB), which picks the winner and reassigns it;
//    - warp D, beside both: the distance code (both candidates, one warp)
//      and the litlen symbols' frequency-rank order, which it hands to A
//      for the reassignment (kBarRank); then, once A hands it the litlen
//      lengths (kBarLL), the header's run lengths, the code-length code
//      (one warp), the header cost and the stored/fixed/dynamic choice,
//      which it hands to A and B (kBarMode); meanwhile A and B compute the
//      litlen code's canonical codes, and then write the litlen outputs.
//    kLLWarps is the fastest of 1, 2, 4 and 8 warps a group, timed in
//    turns on an L6 group on the H100.
//    A symbol stays with one thread (its frequency, depth and lengths in
//    registers). A repair pass that would sort (the original's bitonic
//    sorts of 512 slots) computes each symbol's prefix in the sorted order
//    directly, as the sum over the symbols whose key is smaller: the keys
//    are unique (the index in their low bits), so the sum is the sorted
//    scan's. In one warp the other symbols come by shuffles; in a group,
//    from shared memory. A reduction is a 5-shuffle warp reduction and,
//    in a group, one named barrier over alternating slots.
//    A repair loop ends once a pass changes nothing (each pass is a
//    function of the current lengths alone, so the result is the fixed
//    loop count's). The float steps use the _rn intrinsics so that nvcc
//    contracts nothing into an FMA, and the depths are computed as the
//    plain version computes them: float32 ratio, the float64 log2 of
//    CUDA's math library, rounded to float32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

// The fixed tables (deflate_device._const, int64 on the device), the
// inputs and the outputs; zippy_tpu_torch/ops/huffman_kernels._Args has the
// same fields in the same order.
struct HuffmanArgs {
  const long long* ll_hist;         // (rows, 286)
  const long long* dist_hist;       // (rows, 30)
  const long long* n;               // (rows,)
  const long long* fixed_ll;        // (286,)
  const long long* fixed_ll_codes;  // (286,)
  const long long* fixed_d;         // (30,)
  const long long* fixed_d_codes;   // (30,)
  const long long* len_extra;       // (29,)
  const long long* dist_extra;      // (30,)
  const long long* clcl_order;      // (19,)
  const long long* cl_extra;        // (19,)
  long long* ll_lens;               // (rows, 286)
  long long* d_lens;                // (rows, 30)
  long long* cl_lens;               // (rows, 19)
  long long* mode;                  // (rows,)
  long long* use_ll;                // (rows, 286)
  long long* ll_codes;              // (rows, 286)
  long long* use_d;                 // (rows, 30)
  long long* d_codes;               // (rows, 30)
};

namespace {

constexpr int kLitLen = 286;
constexpr int kDist = 30;
constexpr int kCodeLen = 19;
constexpr int kLLWarps = 4;            // warps of group A, and of group B
constexpr int kRowsPerCta = 1;
constexpr int kThreads = (2 * kLLWarps + 1) * 32;
constexpr int kGroup = kLLWarps * 32;  // threads of group A (and of B)
constexpr int kPerThread = (kLitLen + kGroup - 1) / kGroup;
constexpr int kFkeyMax = (1 << 20) - 1;
constexpr unsigned kAll = 0xffffffffu;
// Named barriers (0 is __syncthreads, which nothing here uses).
constexpr int kBarA = 1, kBarB = 2, kBarAB = 3, kBarLL = 4, kBarMode = 5,
              kBarRank = 6;

static_assert(kCodeLen <= 32 && kDist <= 32, "one symbol a lane");

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

struct Sum {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};
struct Max {
  __device__ long long operator()(long long a, long long b) const {
    return a > b ? a : b;
  }
};

template <typename Op>
__device__ __forceinline__ long long warp_reduce(long long v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// A group of NW warps that synchronizes alone: __syncwarp for one warp, a
// named barrier for more. Its reductions alternate between two sets of
// slots, so that one barrier a reduction suffices: a set is written again
// only after the next reduction's barrier, which every thread reaches
// after it has read this one.
template <int NW>
struct Group {
  int t;           // this thread's index in the group
  int bar;         // its named barrier (NW > 1)
  long long* red;  // 2 * NW slots of shared memory (NW > 1)
  int parity;

  __device__ void sync() const {
    if (NW == 1)
      __syncwarp();
    else
      bar_sync(bar, NW * 32);
  }
  template <typename Op>
  __device__ long long reduce(long long v, Op op) {
    v = warp_reduce(v, op);
    if (NW == 1) return v;
    long long* r = red + parity * NW;
    parity ^= 1;
    if ((t & 31) == 0) r[t >> 5] = v;
    sync();
    long long out = r[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) out = op(out, r[w]);
    return out;
  }
  __device__ long long sum(long long v) { return reduce(v, Sum()); }
  __device__ long long max(long long v) { return reduce(v, Max()); }
};

// A code's symbols as one group holds them: symbol t + i * NW * 32 with
// thread t, P of them a thread, and two shared arrays of S ints for the
// passes that read other threads' symbols (keys and gains or costs; with
// one warp, shuffles take their place).
template <int NW, int P>
struct Code {
  int S, limit;
  long long f[P];  // frequency (0 past S)
  int l[P];        // the candidate's lengths
  float nll[P];    // ideal depth
  int fkey[P];     // min(frequency, kFkeyMax)
  int* key;        // shared, S
  int* val;        // shared, S

  __device__ int sym(const Group<NW>& g, int i) const {
    return g.t + i * NW * 32;
  }

  // sum over the symbols j with key[j] < mine (less_equal: <=) of val[j],
  // for each of this thread's symbols, keys and vals given per symbol.
  // Unique keys make it the scan of the vals in the key order.
  template <bool kLessEqual>
  __device__ void prefix(Group<NW>& g, const int (&k)[P], const int (&v)[P],
                         long long (&out)[P]) {
#pragma unroll
    for (int i = 0; i < P; ++i) out[i] = 0;
    if (NW == 1) {
      // S <= 32 * P: symbol j is lane j % 32's slot j / 32.
#pragma unroll
      for (int i2 = 0; i2 < P; ++i2)
        for (int lane = 0; lane < 32; ++lane) {
          const int kj = __shfl_sync(kAll, k[i2], lane);
          const int vj = __shfl_sync(kAll, v[i2], lane);
#pragma unroll
          for (int i = 0; i < P; ++i)
            if (kLessEqual ? kj <= k[i] : kj < k[i]) out[i] += vj;
        }
      return;
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int s = sym(g, i);
      if (s < S) {
        key[s] = k[i];
        val[s] = v[i];
      }
    }
    g.sync();
    for (int j = 0; j < S; ++j) {
      const int kj = key[j], vj = val[j];
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (kLessEqual ? kj <= k[i] : kj < k[i]) out[i] += vj;
    }
    g.sync();  // key and val are written again by the next pass
  }

  __device__ long long kraft(Group<NW>& g) {
    long long part = 0;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (f[i] > 0) part += 1 << (limit - l[i]);
    return g.sum(part);
  }

  // `_kraft_lengths`' refine: clamp, then the lengthen, bulk_shorten and
  // consume passes, on l. Each loop ends early once a pass changes
  // nothing: the next pass would see the same lengths.
  __device__ void refine(Group<NW>& g) {
    const long long budget = 1 << limit;
    int k[P], v[P];
    long long pre[P];
#pragma unroll
    for (int i = 0; i < P; ++i)
      l[i] = f[i] > 0 ? min(max(l[i], 1), limit) : 0;

    // Over-subscribed: lengthen the cheapest (least frequent) symbols,
    // those whose gains before them in (frequency, index) order are short
    // of the need.
    for (int it = 0; it < limit; ++it) {
      const long long need = kraft(g) - budget;
      if (need <= 0) break;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const bool cand = f[i] > 0 && l[i] < limit;
        k[i] = (cand ? fkey[i] : 1 << 20) * 512 + sym(g, i);
        v[i] = cand ? 1 << (limit - l[i] - 1) : 0;
      }
      prefix<false>(g, k, v, pre);
      long long changed = 0;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (v[i] > 0 && pre[i] < need) {
          l[i] += 1;
          changed = 1;
        }
      if (!g.max(changed)) break;
    }

    // Spend the slack wholesale, best benefit density first: those whose
    // costs up to and including theirs in (density descending, index)
    // order fit the slack.
    for (int it = 0; it < limit; ++it) {
      const long long slack = budget - kraft(g);
      if (slack <= 0) break;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const bool cand = f[i] > 0 && l[i] >= 2;
        const long long density =
            cand ? min(f[i] >> (limit - l[i]), (long long)kFkeyMax) : -1;
        k[i] = (int)(sym(g, i) - density * 512);  // -(density * 512 - idx)
        v[i] = cand ? 1 << (limit - l[i]) : 0;
      }
      prefix<true>(g, k, v, pre);
      long long changed = 0;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (v[i] > 0 && pre[i] <= slack) {
          l[i] -= 1;
          changed = 1;
        }
      if (!g.max(changed)) break;
    }

    // Exact completion: shorten the most frequent symbol (the first of
    // tied maxima) of the largest cost that still fits. Shortening a
    // symbol of cost c doubles its cost, so the Kraft sum grows by exactly
    // c: the slack is carried, not summed again.
    long long slack = budget - kraft(g);
    for (int it = 0; it < 2 * limit + 4; ++it) {
      long long best = -1;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const long long cost =
            f[i] > 0 && l[i] >= 2 ? 1 << (limit - l[i]) : 1 << 28;
        if (cost <= slack) best = best > cost ? best : cost;
      }
      const long long maxcost = g.max(best);
      if (slack <= 0 || maxcost <= 0) break;  // nothing fits: no change
      long long pick = 0;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const long long cost =
            f[i] > 0 && l[i] >= 2 ? 1 << (limit - l[i]) : 1 << 28;
        const long long fv = cost == maxcost ? f[i] : -1;
        const long long p = ((fv + 1) << 9) | (511 - sym(g, i));
        pick = pick > p ? pick : p;
      }
      const int s = 511 - (int)(g.max(pick) & 511);
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (sym(g, i) == s) l[i] -= 1;
      slack -= maxcost;
    }
  }

  // The ideal depths as deflate_device._ideal_depth computes them.
  __device__ void depths(Group<NW>& g) {
    long long part = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) part += f[i];
    long long total = g.sum(part);
    if (total < 1) total = 1;
    const float ftotal = __ll2float_rn(total);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float ratio =
          __fdiv_rn(ftotal, __ll2float_rn(f[i] > 1 ? f[i] : 1));
      nll[i] = __double2float_rn(log2((double)ratio));
      fkey[i] = (int)min(f[i], (long long)kFkeyMax);
    }
  }

  // Candidate (a): water-filled ceil with a bisected offset, repaired.
  __device__ void candidate_a(Group<NW>& g) {
    const long long budget = 1 << limit;
    float lo = -(float)limit, hi = (float)limit;
    for (int it = 0; it < 30; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      long long ks = 0;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (f[i] > 0) {
          const float c = fminf(
              fmaxf(ceilf(__fadd_rn(nll[i], mid)), 1.0f), (float)limit);
          ks += 1 << (limit - (int)c);
        }
      if (g.sum(ks) <= budget)
        hi = mid;
      else
        lo = mid;
    }
    // Clamped to [1, limit] by refine (the depths lie in [0, 64), so the
    // float -> int conversion is exact).
#pragma unroll
    for (int i = 0; i < P; ++i)
      l[i] = (int)fminf(ceilf(__fadd_rn(nll[i], hi)), 64.0f);
    refine(g);
  }

  // Candidate (b): nearest rounding, repaired.
  __device__ void candidate_b(Group<NW>& g) {
#pragma unroll
    for (int i = 0; i < P; ++i)
      l[i] = (int)fminf(floorf(__fadd_rn(nll[i], 0.5f)), 64.0f);
    refine(g);
  }

  __device__ long long bits(Group<NW>& g) {
    long long part = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) part += f[i] * l[i];
    return g.sum(part);
  }

  // Reassign the lengths l (the winner's) by frequency rank into out: the
  // active symbols in (frequency descending, index ascending) order take
  // the lengths in ascending order; ranks[s] is symbol s's place in that
  // order (rank_order). cnt: 16 shared ints.
  __device__ void reassign(Group<NW>& g, const int* ranks, int* cnt,
                           int* out) {
    if (g.t < 16) cnt[g.t] = 0;
    g.sync();
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (f[i] > 0) atomicAdd(&cnt[l[i]], 1);
    g.sync();
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int s = sym(g, i);
      if (s >= S) continue;
      int v = 0;
      if (f[i] > 0) {
        int below = 0;
        for (v = 1; v < 16; ++v) {
          below += cnt[v];
          if (ranks[s] < below) break;
        }
      }
      out[s] = v;
    }
  }
};

// ranks[s], for s < S, the place of symbol s in (frequency descending,
// index ascending) order, from its histogram, by one warp: the number of
// symbols whose key ((2^20 - min(frequency, kFkeyMax)) * 512 + index,
// unique) is smaller. key: S shared ints of scratch.
__device__ void rank_order(const long long* hist, int S, int* key,
                           int* ranks) {
  const int t = (int)threadIdx.x & 31;
  for (int s = t; s < S; s += 32)
    key[s] = ((1 << 20) - (int)min(hist[s], (long long)kFkeyMax)) * 512 + s;
  __syncwarp();
  for (int s = t; s < S; s += 32) {
    const int ks = key[s];
    int r = 0;
    for (int j = 0; j < S; ++j) r += key[j] < ks;
    ranks[s] = r;
  }
  __syncwarp();
}

// Canonical codes of one code (RFC 1951 3.2.2), bit-reversed for LSB-first
// emission, as deflate_device._rev_codes_device computes them: symbol s of
// lens[0 .. S), first[] the first code of each length.
__device__ long long rev_code(const int* lens, const int* first, int s) {
  const int len = lens[s];
  if (len == 0) return 0;
  long long x = first[len];
  for (int u = 0; u < s; ++u) x += lens[u] == len;
  x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555);
  x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333);
  x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F);
  x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF);
  return (x >> 1) >> (15 - len);
}

// first[b], the first canonical code of length b, for lens[0 .. S), by one
// warp; cnt: 16 shared ints of scratch.
__device__ void first_codes(const int* lens, int S, int* cnt, int* first) {
  const int t = (int)threadIdx.x & 31;
  if (t < 16) cnt[t] = 0;
  __syncwarp();
  for (int s = t; s < S; s += 32) atomicAdd(&cnt[lens[s]], 1);
  __syncwarp();
  if (t == 0) {
    first[0] = first[1] = 0;
    for (int b = 2; b < 16; ++b)
      first[b] = (first[b - 1] + cnt[b - 1]) << 1;
  }
  __syncwarp();
}

// One code of at most 32 symbols (lane s holds symbol s, frequency f) built
// by one warp: both candidates, the cheaper ((a) on a tie), reassigned by
// frequency rank. Returns the lane's length.
__device__ int warp_code(long long f, int S, int limit) {
  const int lane = (int)threadIdx.x & 31;
  Group<1> g{lane, 0, nullptr, 0};
  Code<1, 1> c;
  c.S = S;
  c.limit = limit;
  c.f[0] = lane < S ? f : 0;
  c.depths(g);
  c.candidate_b(g);
  const int lb = c.l[0];
  const long long bits_b = c.bits(g);
  c.candidate_a(g);
  if (c.bits(g) > bits_b) c.l[0] = lb;
  // Lane b < 16 counts the active symbols of length b.
  const unsigned act = __ballot_sync(kAll, c.f[0] > 0);
  int cnt = 0;
  for (int s = 0; s < S; ++s) {
    const int ls = __shfl_sync(kAll, c.l[0], s);
    cnt += (act >> s & 1) && ls == lane;
  }
  int k[1] = {((1 << 20) - c.fkey[0]) * 512 + lane};
  int one[1] = {lane < S};
  long long rank[1];
  c.prefix<false>(g, k, one, rank);
  int len = 0, below = 0;
  for (int b = 1; b < 16; ++b) {
    below += __shfl_sync(kAll, cnt, b);
    if (len == 0 && rank[0] < below) len = b;
  }
  return c.f[0] > 0 ? len : 0;
}

__device__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return q * b > a ? q - 1 : q;
}

struct Shared {
  long long red_a[2 * kLLWarps];
  long long red_b[2 * kLLWarps];
  int key_a[kLitLen], val_a[kLitLen];
  int key_b[kLitLen], val_b[kLitLen];
  int cnt_a[16], cnt_ll[16], cnt_d[16];
  int rkey[kLitLen], rank_ll[kLitLen];
  int first_ll[16], first_d[16];
  unsigned long long cl_freq[kCodeLen];
  int ll_len[kLitLen];
  int d_len[kDist];
  int cl_len[kCodeLen];
  long long bits_b;
  int lb[kLitLen];  // group B's repaired candidate
  int mode;
};

__global__ void __launch_bounds__(kThreads)
    huffman_tables_kernel(HuffmanArgs a) {
  __shared__ Shared sh;
  const int tid = (int)threadIdx.x;
  const long long row = blockIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long* ll_hist = a.ll_hist + row * kLitLen;
  const long long* d_hist = a.dist_hist + row * kDist;

  if (warp < 2 * kLLWarps) {
    // Groups A and B: the litlen code, candidate (a) and (b) side by side.
    const bool is_a = warp < kLLWarps;
    Group<kLLWarps> g{is_a ? tid : tid - kGroup, is_a ? kBarA : kBarB,
                      is_a ? sh.red_a : sh.red_b, 0};
    Code<kLLWarps, kPerThread> c;
    c.S = kLitLen;
    c.limit = 15;
    c.key = is_a ? sh.key_a : sh.key_b;
    c.val = is_a ? sh.val_a : sh.val_b;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int s = c.sym(g, i);
      c.f[i] = s < kLitLen ? ll_hist[s] : 0;
    }
    c.depths(g);
    if (!is_a) {
      c.candidate_b(g);
      const long long bits = c.bits(g);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        if (c.sym(g, i) < kLitLen) sh.lb[c.sym(g, i)] = c.l[i];
      if (g.t == 0) sh.bits_b = bits;
      bar_arrive(kBarAB, 2 * kGroup);  // B's lengths and cost to A
    } else {
      c.candidate_a(g);
      const long long bits_a = c.bits(g);
      bar_sync(kBarAB, 2 * kGroup);
      if (bits_a > sh.bits_b) {  // the cheaper wins, (a) on a tie
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          if (c.sym(g, i) < kLitLen) c.l[i] = sh.lb[c.sym(g, i)];
      }
      bar_sync(kBarRank, kGroup + 32);  // D's rank order of the symbols
      c.reassign(g, sh.rank_ll, sh.cnt_a, sh.ll_len);
    }
    bar_sync(kBarLL, 2 * kGroup + 32);  // the litlen lengths to A, B, D
    // A and B: the litlen code's canonical codes while D finishes the
    // header; then, given the mode, the litlen outputs.
    const int t2 = tid;  // 0 .. 2 * kGroup
    if (warp == 0) first_codes(sh.ll_len, kLitLen, sh.cnt_ll, sh.first_ll);
    bar_sync(kBarAB, 2 * kGroup);
    long long code[(kLitLen + 2 * kGroup - 1) / (2 * kGroup)];
#pragma unroll
    for (int i = 0; i < (kLitLen + 2 * kGroup - 1) / (2 * kGroup); ++i) {
      const int s = t2 + i * 2 * kGroup;
      code[i] = s < kLitLen ? rev_code(sh.ll_len, sh.first_ll, s) : 0;
    }
    bar_sync(kBarMode, 2 * kGroup + 32);
    const int mode = sh.mode;
#pragma unroll
    for (int i = 0; i < (kLitLen + 2 * kGroup - 1) / (2 * kGroup); ++i) {
      const int s = t2 + i * 2 * kGroup;
      if (s >= kLitLen) continue;
      const long long len = sh.ll_len[s];
      a.ll_lens[row * kLitLen + s] = len;
      a.use_ll[row * kLitLen + s] = mode == 2 ? len : a.fixed_ll[s];
      a.ll_codes[row * kLitLen + s] =
          mode == 2 ? code[i] : a.fixed_ll_codes[s];
    }
    return;
  }

  // Warp D: the distance code, then the header, the code-length code and
  // the mode.
  const int d_len = warp_code(lane < kDist ? d_hist[lane] : 0, kDist, 15);
  if (lane < kDist) sh.d_len[lane] = d_len;
  // While A and B build their candidates: the litlen code's rank order,
  // for A's reassignment.
  rank_order(ll_hist, kLitLen, sh.rkey, sh.rank_ll);
  bar_arrive(kBarRank, kGroup + 32);
  bar_sync(kBarLL, 2 * kGroup + 32);

  // The dynamic header: HLIT, HDIST, the RLE of the lengths in closed form
  // per run, the code-length code. Lane t takes lengths t, t + 32, ...
  constexpr int kTotalMax = kLitLen + kDist;
  constexpr int kPerLane = (kTotalMax + 31) / 32;
  long long last = -1;
  for (int s = lane; s < kLitLen; s += 32)
    if (sh.ll_len[s] > 0) last = s;
  const int hlit = max(257, (int)warp_reduce(last, Max()) + 1);
  last = lane < kDist && sh.d_len[lane] > 0 ? lane : -1;
  const int hdist = max(1, (int)warp_reduce(last, Max()) + 1);
  const int total = hlit + hdist;
  const auto len_at = [&](int j) {
    return j < hlit ? sh.ll_len[j] : sh.d_len[j - hlit];
  };
  // Each run's first position, and its end: the next run's first position
  // (a suffix minimum over the lanes' slices of the 316 positions).
  if (lane < kCodeLen) sh.cl_freq[lane] = 0;
  int mine = total;  // the first run start in this lane's slice
  for (int i = kPerLane - 1; i >= 0; --i) {
    const int j = lane * kPerLane + i;
    if (j < total && (j == 0 || len_at(j) != len_at(j - 1))) mine = j;
  }
  int m = mine;  // the first run start in this lane's slice or later ones
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kAll, m, o);
    if (lane + o < 32) m = min(m, y);
  }
  int end = __shfl_down_sync(kAll, m, 1);
  if (lane == 31) end = total;
  __syncwarp();
  for (int i = kPerLane - 1; i >= 0; --i) {
    const int j = lane * kPerLane + i;
    if (j >= total) continue;
    const int vj = len_at(j);
    if (j > 0 && vj == len_at(j - 1)) continue;
    const int r = end - j;
    end = j;
    if (vj == 0) {
      const int q = r / 138, mm = r % 138;
      if (q + (mm > 10))
        atomicAdd(&sh.cl_freq[18], (unsigned long long)(q + (mm > 10)));
      if (mm >= 3 && mm <= 10) atomicAdd(&sh.cl_freq[17], 1ull);
      if (mm < 3 && mm) atomicAdd(&sh.cl_freq[0], (unsigned long long)mm);
    } else {
      const int r1 = r - 1, q = r1 / 6, mm = r1 % 6;
      if (q + (mm >= 3))
        atomicAdd(&sh.cl_freq[16], (unsigned long long)(q + (mm >= 3)));
      atomicAdd(&sh.cl_freq[vj],
                (unsigned long long)(1 + (mm < 3 ? mm : 0)));
    }
  }
  __syncwarp();
  const long long cl_freq =
      lane < kCodeLen ? (long long)sh.cl_freq[lane] : 0;
  const int cl_len = warp_code(cl_freq, kCodeLen, 7);
  if (lane < kCodeLen) sh.cl_len[lane] = cl_len;
  __syncwarp();
  long long emis = 0;
  last = -1;
  if (lane < kCodeLen) {
    emis = cl_freq * (sh.cl_len[lane] + a.cl_extra[lane]);
    if (sh.cl_len[a.clcl_order[lane]] > 0) last = lane;
  }
  const int hclen = max(4, (int)warp_reduce(last, Max()) + 1);
  const long long header_bits = 14 + 3 * hclen + warp_reduce(emis, Sum());

  // The stored/fixed/dynamic choice.
  long long dyn = 0, fix = 0, extra = 0;
  for (int s = lane; s < kLitLen; s += 32) {
    const long long h = ll_hist[s];
    dyn += h * sh.ll_len[s];
    fix += h * a.fixed_ll[s];
    if (s >= 257) extra += h * a.len_extra[s - 257];
  }
  if (lane < kDist) {
    const long long h = d_hist[lane];
    dyn += h * sh.d_len[lane];
    fix += h * a.fixed_d[lane];
    extra += h * a.dist_extra[lane];
  }
  extra = warp_reduce(extra, Sum());
  const long long dyn_bits =
      3 + header_bits + warp_reduce(dyn, Sum()) + extra;
  const long long fix_bits = 3 + warp_reduce(fix, Sum()) + extra;
  const long long n = a.n[row];
  const long long stored_bits =
      8 * (n + 5 * floor_div(n + 0xFFFE, 0xFFFF)) + 7;
  const int mode = stored_bits < min(dyn_bits, fix_bits) ? 0
                   : fix_bits <= dyn_bits                 ? 1
                                                          : 2;
  if (lane == 0) sh.mode = mode;
  bar_arrive(kBarMode, 2 * kGroup + 32);  // the mode to A and B

  if (lane == 0) a.mode[row] = mode;
  if (lane < kCodeLen) a.cl_lens[row * kCodeLen + lane] = sh.cl_len[lane];
  first_codes(sh.d_len, kDist, sh.cnt_d, sh.first_d);
  if (lane < kDist) {
    const long long len = sh.d_len[lane];
    a.d_lens[row * kDist + lane] = len;
    a.use_d[row * kDist + lane] = mode == 2 ? len : a.fixed_d[lane];
    a.d_codes[row * kDist + lane] =
        mode == 2 ? rev_code(sh.d_len, sh.first_d, lane)
                  : a.fixed_d_codes[lane];
  }
}

}  // namespace

extern "C" {

// One K5 launch: one CTA of kThreads threads a row (kRowsPerCta), each
// building its row of the group from args' inputs into args' outputs
// (every pointer a contiguous int64 device buffer of the shape HuffmanArgs
// gives it).
int zt_huffman_tables(const HuffmanArgs* args, int rows, void* stream,
                      int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    huffman_tables_kernel<<<(rows + kRowsPerCta - 1) / kRowsPerCta,
                            kThreads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
