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
//    passes, each a block-wide sort or reduction ended by a barrier). The
//    torch version issued each pass as separate launches, about 13,400 a
//    group with the card mostly idle.
//    Design: everything a row needs stays in shared memory (histograms,
//    float32 depths, both candidate length vectors, a 512-slot sort
//    buffer); a pass is a bitonic sort of unique int32 keys, a block-wide
//    scan or a block-wide reduction; a repair loop ends once a pass would
//    change nothing (each pass is a function of the current lengths alone,
//    so the result is the fixed loop count's). The float steps use the _rn
//    intrinsics so that nvcc contracts nothing into an FMA, and the depths
//    are computed as the plain version computes them: float32 ratio, the
//    float64 log2 of CUDA's math library, rounded to float32.

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

constexpr int kThreads = 256;
constexpr int kLitLen = 286;
constexpr int kDist = 30;
constexpr int kCodeLen = 19;
constexpr int kSort = 512;             // sort slots: 2 * kThreads
constexpr int kFkeyMax = (1 << 20) - 1;
constexpr int kPadKey = 1 << 30;       // after every real key (< 2^29 + 512)
constexpr int kWarps = kThreads / 32;

static_assert(kSort == 2 * kThreads, "one compare-exchange a thread");

// One row's workspace, all in shared memory.
struct Shared {
  long long ll_hist[kLitLen];
  long long d_hist[kDist];
  long long cl_freq[kCodeLen];
  long long red[kWarps];
  float nll[kLitLen];
  int fkey[kLitLen];
  int la[kLitLen];
  int lb[kLitLen];
  int key[kSort];
  int val[kSort];
  int buf[kSort];
  int cnt[16];
  int first[16];
  int ll_len[kLitLen];
  int d_len[kDist];
  int cl_len[kCodeLen];
};

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

// The reduction of every thread's v, returned to every thread.
template <typename Op>
__device__ long long block_reduce(long long v, Op op, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the previous reduction's reads are done
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = sh.red[0];
  for (int w = 1; w < kWarps; ++w) r = op(r, sh.red[w]);
  return r;
}

__device__ long long block_sum(long long v, Shared& sh) {
  return block_reduce(v, Sum(), sh);
}

__device__ long long block_max(long long v, Shared& sh) {
  return block_reduce(v, Max(), sh);
}

// Inclusive prefix sum of buf[0 .. n), n <= kSort, in place; two slots a
// thread. Every value and sum fits int32 (at most 286 * 2^14).
__device__ void block_scan(int* buf, int n, Shared& sh) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // Other threads wrote buf, and may still read the previous reduction's
  // red.
  __syncthreads();
  const int a0 = 2 * t < n ? buf[2 * t] : 0;
  const int a1 = 2 * t + 1 < n ? buf[2 * t + 1] : 0;
  int x = a0 + a1;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh.red[warp] = x;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += (int)sh.red[w];
  const int before = base + x - a0 - a1;
  if (2 * t < n) buf[2 * t] = before + a0;
  if (2 * t + 1 < n) buf[2 * t + 1] = before + a0 + a1;
  __syncthreads();
}

// Ascending bitonic sort of key[0 .. n) with val beside it, n a power of
// two <= kSort. The keys are unique, so the order is the argsort's.
__device__ void sort_pairs(int* key, int* val, int n) {
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += kThreads) {
        const int i = 2 * p - (p & (j - 1));
        const int q = i + j;
        const int ki = key[i], kq = key[q];
        if ((ki > kq) == ((i & k) == 0)) {
          key[i] = kq;
          key[q] = ki;
          const int v = val[i];
          val[i] = val[q];
          val[q] = v;
        }
      }
      __syncthreads();
    }
  }
}

// The Kraft sum sum(2^(limit - l)) over the active symbols, block-wide.
__device__ long long kraft_sum(const long long* freq, const int* l, int S,
                               int limit, Shared& sh) {
  long long part = 0;
  for (int s = threadIdx.x; s < S; s += kThreads)
    if (freq[s] > 0) part += 1 << (limit - l[s]);
  return block_sum(part, sh);
}

// `_kraft_lengths`' refine: clamp, then the lengthen, bulk_shorten and
// consume passes, in place on l. Each loop ends early once a pass changes
// nothing: the next pass would see the same lengths.
__device__ void refine(const long long* freq, int* l, int S, int limit,
                       Shared& sh) {
  const int t = threadIdx.x;
  const int budget = 1 << limit;
  const int n = S > 32 ? kSort : 32;
  for (int s = t; s < S; s += kThreads)
    l[s] = freq[s] > 0 ? min(max(l[s], 1), limit) : 0;

  // Over-subscribed: lengthen the cheapest (least frequent) symbols.
  for (int it = 0; it < limit; ++it) {
    const long long need = kraft_sum(freq, l, S, limit, sh) - budget;
    if (need <= 0) break;
    for (int i = t; i < n; i += kThreads) {
      sh.val[i] = i;
      sh.key[i] = i < S ? (freq[i] > 0 && l[i] < limit ? sh.fkey[i] : 1 << 20)
                              * 512 + i
                        : kPadKey + i;
    }
    sort_pairs(sh.key, sh.val, n);
    for (int i = t; i < n; i += kThreads) {
      const int s = sh.val[i];
      sh.buf[i] = s < S && freq[s] > 0 && l[s] < limit
                      ? 1 << (limit - l[s] - 1) : 0;
    }
    block_scan(sh.buf, n, sh);
    long long changed = 0;
    for (int i = t; i < n; i += kThreads) {
      const int s = sh.val[i];
      if (s < S && freq[s] > 0 && l[s] < limit) {
        const int gain = 1 << (limit - l[s] - 1);
        if (sh.buf[i] - gain < need) {
          l[s] += 1;
          changed = 1;
        }
      }
    }
    if (!block_max(changed, sh)) break;
  }

  // Spend the slack wholesale, best benefit density first.
  for (int it = 0; it < limit; ++it) {
    const long long slack = budget - kraft_sum(freq, l, S, limit, sh);
    if (slack <= 0) break;
    for (int i = t; i < n; i += kThreads) {
      sh.val[i] = i;
      if (i < S) {
        const bool cand = freq[i] > 0 && l[i] >= 2;
        const long long density =
            cand ? min(freq[i] >> (limit - l[i]), (long long)kFkeyMax) : -1;
        sh.key[i] = (int)(i - density * 512);  // -(density * 512 - idx)
      } else {
        sh.key[i] = kPadKey + i;
      }
    }
    sort_pairs(sh.key, sh.val, n);
    for (int i = t; i < n; i += kThreads) {
      const int s = sh.val[i];
      sh.buf[i] = s < S && freq[s] > 0 && l[s] >= 2 ? 1 << (limit - l[s])
                                                     : 0;
    }
    block_scan(sh.buf, n, sh);
    long long changed = 0;
    for (int i = t; i < n; i += kThreads) {
      const int s = sh.val[i];
      if (s < S && freq[s] > 0 && l[s] >= 2 && sh.buf[i] <= slack) {
        l[s] -= 1;
        changed = 1;
      }
    }
    if (!block_max(changed, sh)) break;
  }

  // Exact completion: shorten the most frequent symbol (the first of tied
  // maxima) of the largest cost that still fits.
  for (int it = 0; it < 2 * limit + 4; ++it) {
    const long long slack = budget - kraft_sum(freq, l, S, limit, sh);
    long long best = -1;
    for (int s = t; s < S; s += kThreads) {
      const int cost = freq[s] > 0 && l[s] >= 2 ? 1 << (limit - l[s])
                                                : 1 << 28;
      if (cost <= slack) best = max(best, (long long)cost);
    }
    const long long maxcost = block_max(best, sh);
    if (slack <= 0 || maxcost <= 0) break;  // nothing fits: no change
    long long pick = 0;
    for (int s = t; s < S; s += kThreads) {
      const int cost = freq[s] > 0 && l[s] >= 2 ? 1 << (limit - l[s])
                                                : 1 << 28;
      const long long f = cost == maxcost ? freq[s] : -1;
      pick = max(pick, ((f + 1) << 9) | (511 - s));
    }
    pick = 511 - (block_max(pick, sh) & 511);
    if (t == 0) l[pick] -= 1;
    __syncthreads();
  }
}

// `_kraft_lengths(freq, limit)` of one row of S <= 286 symbols into out.
__device__ void kraft_lengths(const long long* freq, int S, int limit,
                              int* out, Shared& sh) {
  const int t = threadIdx.x;
  const int budget = 1 << limit;
  const int n = S > 32 ? kSort : 32;
  __syncthreads();
  long long part = 0;
  for (int s = t; s < S; s += kThreads) part += freq[s];
  long long total = block_sum(part, sh);
  if (total < 1) total = 1;
  // The ideal depths as deflate_device._ideal_depth computes them.
  const float ftotal = __ll2float_rn(total);
  for (int s = t; s < S; s += kThreads) {
    const long long f = freq[s];
    const float ratio = __fdiv_rn(ftotal, __ll2float_rn(f > 1 ? f : 1));
    sh.nll[s] = __double2float_rn(log2((double)ratio));
    sh.fkey[s] = (int)min(f, (long long)kFkeyMax);
  }
  __syncthreads();

  // Candidate (a): water-filled ceil with a bisected offset.
  float lo = -(float)limit, hi = (float)limit;
  for (int it = 0; it < 30; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    long long ks = 0;
    for (int s = t; s < S; s += kThreads) {
      if (freq[s] > 0) {
        const float c = fminf(fmaxf(ceilf(__fadd_rn(sh.nll[s], mid)), 1.0f),
                              (float)limit);
        ks += 1 << (limit - (int)c);
      }
    }
    if (block_sum(ks, sh) <= budget) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  // Candidate (b): nearest rounding. Both clamped to [1, limit] by refine
  // (the depths lie in [0, 64), so the float -> int conversion is exact).
  for (int s = t; s < S; s += kThreads) {
    sh.la[s] = (int)fminf(ceilf(__fadd_rn(sh.nll[s], hi)), 64.0f);
    sh.lb[s] = (int)fminf(floorf(__fadd_rn(sh.nll[s], 0.5f)), 64.0f);
  }
  __syncthreads();
  refine(freq, sh.la, S, limit, sh);
  refine(freq, sh.lb, S, limit, sh);

  long long bits_a = 0, bits_b = 0;
  for (int s = t; s < S; s += kThreads) {
    bits_a += freq[s] * sh.la[s];
    bits_b += freq[s] * sh.lb[s];
  }
  bits_a = block_sum(bits_a, sh);
  bits_b = block_sum(bits_b, sh);
  const int* lens = bits_a <= bits_b ? sh.la : sh.lb;

  // Reassign the winning multiset by frequency rank: the active symbols in
  // (frequency descending, index ascending) order take the lengths in
  // ascending order.
  if (t < 16) sh.cnt[t] = 0;
  for (int i = t; i < n; i += kThreads) {
    sh.val[i] = i;
    sh.key[i] = i < S ? ((1 << 20) - sh.fkey[i]) * 512 + i : kPadKey + i;
  }
  __syncthreads();
  for (int s = t; s < S; s += kThreads)
    if (freq[s] > 0) atomicAdd(&sh.cnt[lens[s]], 1);
  sort_pairs(sh.key, sh.val, n);
  for (int r = t; r < S; r += kThreads) {
    const int s = sh.val[r];
    int v = 0;
    if (freq[s] > 0) {
      int below = 0;
      for (v = 1; v < 16; ++v) {
        below += sh.cnt[v];
        if (r < below) break;
      }
    }
    out[s] = v;
  }
  __syncthreads();
}

// Canonical codes of one code (RFC 1951 3.2.2), bit-reversed for LSB-first
// emission, as deflate_device._rev_codes_device computes them.
__device__ void rev_codes(const int* lens, int S, long long* out,
                          Shared& sh) {
  const int t = threadIdx.x;
  __syncthreads();
  if (t < 16) sh.cnt[t] = 0;
  __syncthreads();
  for (int s = t; s < S; s += kThreads) atomicAdd(&sh.cnt[lens[s]], 1);
  __syncthreads();
  if (t == 0) {
    sh.first[0] = sh.first[1] = 0;
    for (int b = 2; b < 16; ++b)
      sh.first[b] = (sh.first[b - 1] + sh.cnt[b - 1]) << 1;
  }
  __syncthreads();
  for (int s = t; s < S; s += kThreads) {
    const int len = lens[s];
    long long code = 0;
    if (len > 0) {
      long long x = sh.first[len];
      for (int u = 0; u < s; ++u) x += lens[u] == len;
      x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555);
      x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333);
      x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F);
      x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF);
      code = (x >> 1) >> (15 - len);
    }
    out[s] = code;
  }
}

__device__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return q * b > a ? q - 1 : q;
}

__global__ void __launch_bounds__(kThreads)
    huffman_tables_kernel(HuffmanArgs a) {
  __shared__ Shared sh;
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  for (int s = t; s < kLitLen; s += kThreads)
    sh.ll_hist[s] = a.ll_hist[row * kLitLen + s];
  for (int s = t; s < kDist; s += kThreads)
    sh.d_hist[s] = a.dist_hist[row * kDist + s];

  kraft_lengths(sh.ll_hist, kLitLen, 15, sh.ll_len, sh);
  kraft_lengths(sh.d_hist, kDist, 15, sh.d_len, sh);

  // The dynamic header: HLIT, HDIST, the RLE of the lengths in closed form
  // per run (each run's first thread walks it), the code-length code.
  long long last = -1;
  for (int s = t; s < kLitLen; s += kThreads)
    if (sh.ll_len[s] > 0) last = max(last, (long long)s);
  const int hlit = max(257, (int)block_max(last, sh) + 1);
  last = -1;
  for (int s = t; s < kDist; s += kThreads)
    if (sh.d_len[s] > 0) last = max(last, (long long)s);
  const int hdist = max(1, (int)block_max(last, sh) + 1);
  const int total = hlit + hdist;
  if (t < kCodeLen) sh.cl_freq[t] = 0;
  __syncthreads();
  for (int j = t; j < total; j += kThreads) {
    const int v = j < hlit ? sh.ll_len[j] : sh.d_len[j - hlit];
    const int prev = j == 0 ? -2
                     : j - 1 < hlit ? sh.ll_len[j - 1]
                                    : sh.d_len[j - 1 - hlit];
    if (v == prev) continue;
    int r = 1;
    while (j + r < total
           && (j + r < hlit ? sh.ll_len[j + r] : sh.d_len[j + r - hlit]) == v)
      ++r;
    unsigned long long* f = (unsigned long long*)sh.cl_freq;
    if (v == 0) {
      const int q = r / 138, m = r % 138;
      if (q + (m > 10)) atomicAdd(&f[18], (unsigned long long)(q + (m > 10)));
      if (m >= 3 && m <= 10) atomicAdd(&f[17], 1ull);
      if (m < 3 && m) atomicAdd(&f[0], (unsigned long long)m);
    } else {
      const int r1 = r - 1, q = r1 / 6, m = r1 % 6;
      if (q + (m >= 3)) atomicAdd(&f[16], (unsigned long long)(q + (m >= 3)));
      atomicAdd(&f[v], (unsigned long long)(1 + (m < 3 ? m : 0)));
    }
  }
  kraft_lengths(sh.cl_freq, kCodeLen, 7, sh.cl_len, sh);
  long long emis = 0;
  last = -1;
  if (t < kCodeLen) {
    emis = sh.cl_freq[t] * (sh.cl_len[t] + a.cl_extra[t]);
    if (sh.cl_len[a.clcl_order[t]] > 0) last = t;
  }
  const int hclen = max(4, (int)block_max(last, sh) + 1);
  const long long header_bits = 14 + 3 * hclen + block_sum(emis, sh);

  // The stored/fixed/dynamic choice.
  long long dyn = 0, fix = 0, extra = 0;
  for (int s = t; s < kLitLen; s += kThreads) {
    const long long h = sh.ll_hist[s];
    dyn += h * sh.ll_len[s];
    fix += h * a.fixed_ll[s];
    if (s >= 257) extra += h * a.len_extra[s - 257];
  }
  for (int s = t; s < kDist; s += kThreads) {
    const long long h = sh.d_hist[s];
    dyn += h * sh.d_len[s];
    fix += h * a.fixed_d[s];
    extra += h * a.dist_extra[s];
  }
  extra = block_sum(extra, sh);
  const long long dyn_bits = 3 + header_bits + block_sum(dyn, sh) + extra;
  const long long fix_bits = 3 + block_sum(fix, sh) + extra;
  const long long n = a.n[row];
  const long long stored_bits =
      8 * (n + 5 * floor_div(n + 0xFFFE, 0xFFFF)) + 7;
  const int mode = stored_bits < min(dyn_bits, fix_bits) ? 0
                   : fix_bits <= dyn_bits                 ? 1
                                                          : 2;

  if (t == 0) a.mode[row] = mode;
  for (int s = t; s < kLitLen; s += kThreads) {
    a.ll_lens[row * kLitLen + s] = sh.ll_len[s];
    a.use_ll[row * kLitLen + s] = mode == 2 ? sh.ll_len[s] : a.fixed_ll[s];
  }
  for (int s = t; s < kDist; s += kThreads) {
    a.d_lens[row * kDist + s] = sh.d_len[s];
    a.use_d[row * kDist + s] = mode == 2 ? sh.d_len[s] : a.fixed_d[s];
  }
  if (t < kCodeLen) a.cl_lens[row * kCodeLen + t] = sh.cl_len[t];
  if (mode == 2) {
    rev_codes(sh.ll_len, kLitLen, a.ll_codes + row * kLitLen, sh);
    rev_codes(sh.d_len, kDist, a.d_codes + row * kDist, sh);
  } else {
    for (int s = t; s < kLitLen; s += kThreads)
      a.ll_codes[row * kLitLen + s] = a.fixed_ll_codes[s];
    for (int s = t; s < kDist; s += kThreads)
      a.d_codes[row * kDist + s] = a.fixed_d_codes[s];
  }
}

}  // namespace

extern "C" {

// One K5 launch: `rows` CTAs, each building one row of the group from
// args' inputs into args' outputs (every pointer a contiguous int64 device
// buffer of the shape HuffmanArgs gives it).
int zt_huffman_tables(const HuffmanArgs* args, int rows, void* stream,
                      int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    huffman_tables_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        *args);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
