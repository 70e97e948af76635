// Hand-written Hopper (sm_90a) kernel for the encoder's bit packing.
//
// Built by zippy_tpu_torch/ops/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: the entry point takes raw device pointers and the
// caller's stream, launches one kernel, allocates nothing, and returns the
// first CUDA error it met (0 when the launch was accepted).
//
// K8 zt_pack_tokens replaces the jnp/XLA `pack_tokens`
//    (zippy_tpu/ops/deflate_device.py:361). In the port its plain version
//    is pack_kernels.pack_tokens_plain, whose outputs it equals element for
//    element. For each row (block) of an encode group it serializes the
//    token cover to a DEFLATE bit stream with the row's code tables: per
//    token the litlen code, the length's extra bits, the distance code and
//    the distance's extra bits (the last three for a match only), each
//    value zero where its bit length is 0, LSB-first from bit 0; then the
//    end-of-block code (symbol 256). Bit k of a row's stream is bit k % 32
//    of its word k / 32; words (G, Wn = N / 2 + 8) int64 hold uint32
//    values, zero past the row's last bit; total_bits (G,) int64.
//
//    Why Wn words always suffice: a code length is at most 15 bits, so a
//    literal costs at most 15 bits and a match at most 15 + 5 + 15 + 13 =
//    48 bits for at least 3 bytes; a row of n <= N bytes costs at most 16 N
//    bits, and with the end-of-block code 16 N + 15 < 32 Wn = 16 N + 256
//    (16 N + 240 for an odd N). The plain version clamps a word index to
//    Wn - 1, which a token cover never reaches; K8 stores no word at or
//    past Wn, and a row whose total_bits exceeded 32 Wn (tokens that are
//    no cover) is refused where the encoder fetches it
//    (deflate_device._finish_fetch), never clipped in silence. Table
//    lengths are DEFLATE's, 0..15 (K5's tables and the fixed ones); K8
//    reads a length's low 4 bits, so that its shifts stay defined. Table
//    and constant indexes are clamped to their tables, where the plain
//    version's gather would raise.
//
//    Bound: the bytes. A position's two bools and, for a token, its symbol
//    and, for a match, its four match fields are read once; the words are
//    written once. Per position a few tens of integer operations.
//    Design: one launch. The row's positions are cut into chunks of kChunk
//    = 4096; a CTA of kThreads = 256 takes one chunk, 16 positions a
//    thread, so a 55-row group of 64 KiB blocks runs 880 CTAs.
//    - The CTA stages its row's tables in shared memory (code | length
//      << 16 per symbol), then reads its chunk's positions coalesced, a
//      position a thread, and leaves each position's whole code in shared
//      memory: the four components concatenated into one value of at most
//      48 bits, with its length in the top byte.
//    - Each thread sums the lengths of its 16 consecutive positions and
//      keeps the last 32 bits of its own stream (its "tail"). (count,
//      tail) pairs combine associatively, (a, b) -> (a.n + b.n, b.n >= 32 ?
//      b.t : a.t >> b.n | b.t), so one scan over the CTA's threads gives
//      each its start bit in the chunk and the 32 bits before it, and the
//      chunk's aggregate.
//    - Chunks meet by decoupled look-back: a CTA takes its chunk from a
//      ticket counter (so every chunk before it belongs to a CTA that
//      already runs), publishes its aggregate, and one warp reads the
//      flags of the chunks before it in its row at once (a row has at most
//      kMaxChunks = 32), combining aggregates back to the nearest inclusive
//      prefix; then it publishes its own inclusive prefix. Each flag is one
//      64-bit word (status << 62 | count << 32 | tail), written whole.
//    - Each thread then writes exactly the words whose last bit lies in
//      its bit range, by plain stores: it starts its 64-bit accumulator
//      with the bits of its first word that lie before it (from the tail
//      before it), appends its codes, and stores a word each time 32 bits
//      are full. A word that its range does not fill is finished by a later
//      thread, which holds its first bits in that tail. So no word is
//      written twice, and there are no atomics on the words.
//    - The row's last chunk appends the end-of-block code, stores the last
//      partial word, writes total_bits, and zeroes the words past the
//      stream with its whole CTA.
//    - The look-back's flags and the two counters (tickets, finished CTAs)
//      live in a scratch buffer per stream (pack_kernels._scratch), zero
//      before a launch; the CTA that finishes last zeroes them again.
//      A CTA that has read a flag kSpinLimit = 2^24 times without the
//      prefix traps (a fault, not a hang).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

// The inputs, the constant tables (device_tables.const, int64), the
// outputs; zippy_tpu_torch/ops/pack_kernels._Args has the same fields in the
// same order.
struct PackArgs {
  const bool* is_tok;          // (G, N)
  const bool* is_match;        // (G, N)
  const long long* sym;        // (G, N)
  const long long* len_idx;    // (G, N)
  const long long* dist_idx;   // (G, N)
  const long long* length;     // (G, N)
  const long long* dist;       // (G, N)
  const long long* ll_lens;    // (G, 286), rows ll_stride apart
  const long long* ll_codes;   // (G, 286), rows ll_stride apart
  const long long* d_lens;     // (G, 30), rows d_stride apart
  const long long* d_codes;    // (G, 30), rows d_stride apart
  const long long* len_extra;  // (29,)
  const long long* base_len;   // (29,)
  const long long* dist_extra; // (30,)
  const long long* base_dist;  // (30,)
  long long* words;            // (G, Wn)
  long long* total_bits;       // (G,)
  unsigned long long* scratch; // G * nchunks flags, then the two counters
};

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;
constexpr int kChunk = kThreads * kPer;  // 4096
constexpr int kMaxChunks = 32;
constexpr int kWarps = kThreads / 32;
constexpr int kLL = 286;
constexpr int kD = 30;
constexpr int kLenCodes = 29;
// Shared-memory slot of a chunk position: one pad word every kPer, so that
// a thread's 16 consecutive positions start in another bank pair than its
// neighbour's.
__device__ __forceinline__ int slot(int q) { return q + (q >> 4); }
constexpr int kSlots = kChunk + kChunk / kPer;

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr long long kSpinLimit = 1ll << 24;

// (count, tail) pairs: `n` bits, whose last 32 are `t` (bit j is stream bit
// n - 32 + j; bits before the stream's start are zero).
struct Run {
  uint32_t n, t;
};

// a then b.
__device__ __forceinline__ Run combine(Run a, Run b) {
  Run r;
  r.n = a.n + b.n;
  r.t = b.n >= 32 ? b.t : (uint32_t)((uint64_t)a.t >> b.n) | b.t;
  return r;
}

// Appends the `m` <= 32 low bits of v to a tail.
__device__ __forceinline__ uint32_t append_tail(uint32_t t, uint64_t v,
                                                uint32_t m) {
  return (uint32_t)((((v & 0xffffffffull) << 32) | t) >> m);
}

__device__ __forceinline__ unsigned long long flag_word(unsigned long long s,
                                                        Run r) {
  return s | ((unsigned long long)r.n << 32) | r.t;
}

__device__ __forceinline__ Run flag_run(unsigned long long f) {
  Run r;
  r.n = (uint32_t)(f >> 32) & 0x3fffffffu;
  r.t = (uint32_t)f;
  return r;
}

// The row's output words: a word index at or past Wn is dropped (a token
// cover never reaches it).
struct Out {
  long long* w;
  int wn;
  __device__ __forceinline__ void store(int i, uint32_t v) const {
    if (i < wn) w[i] = (long long)v;
  }
};

// A thread's accumulator: `n` < 32 bits pending at word `w`.
struct Acc {
  uint64_t a;
  int n, w;
  __device__ __forceinline__ void put(uint64_t v, int m, const Out& o) {
    a |= (v & ((1ull << m) - 1)) << n;   // m <= 32, n < 32
    n += m;
    if (n >= 32) {
      o.store(w, (uint32_t)a);
      a >>= 32;
      n -= 32;
      ++w;
    }
  }
  __device__ __forceinline__ void code(uint64_t c, int m, const Out& o) {
    put(c, m < 32 ? m : 32, o);
    if (m > 32) put(c >> 32, m - 32, o);
  }
};

__device__ __forceinline__ int clampi(long long v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : (int)v);
}

__global__ void __launch_bounds__(kThreads)
pack_tokens_kernel(PackArgs a, int n_pos, int wn, int nchunks,
                   long long ll_stride, long long d_stride, int total_ctas) {
  __shared__ uint64_t s_code[kSlots];
  __shared__ uint32_t s_ll[kLL];      // code | length << 16
  __shared__ uint32_t s_d[kD];
  __shared__ uint32_t s_len[kLenCodes];   // base | extra << 16
  __shared__ uint32_t s_dist[kD];
  __shared__ Run s_warp[kWarps];
  __shared__ Run s_prefix;
  __shared__ int s_ticket, s_zero_from, s_last;

  unsigned long long* flags = a.scratch;
  unsigned int* counters =
      reinterpret_cast<unsigned int*>(a.scratch + total_ctas);
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_ticket = (int)atomicAdd(&counters[0], 1u);
  __syncthreads();
  const int ticket = s_ticket;
  const int row = ticket / nchunks, chunk = ticket % nchunks;
  const bool last_chunk = chunk == nchunks - 1;

  // The row's tables.
  const long long* ll_l = a.ll_lens + row * ll_stride;
  const long long* ll_c = a.ll_codes + row * ll_stride;
  const long long* d_l = a.d_lens + row * d_stride;
  const long long* d_c = a.d_codes + row * d_stride;
  for (int s = tid; s < kLL; s += kThreads) {
    const uint32_t len = (uint32_t)ll_l[s] & 15u;
    s_ll[s] = (len ? (uint32_t)ll_c[s] & 0xffffu : 0u) | len << 16;
  }
  if (tid < kD) {
    const uint32_t len = (uint32_t)d_l[tid] & 15u;
    s_d[tid] = (len ? (uint32_t)d_c[tid] & 0xffffu : 0u) | len << 16;
    s_dist[tid] = ((uint32_t)a.base_dist[tid] & 0xffffu) |
                  ((uint32_t)a.dist_extra[tid] & 15u) << 16;
  }
  if (tid < kLenCodes)
    s_len[tid] = ((uint32_t)a.base_len[tid] & 0xffffu) |
                 ((uint32_t)a.len_extra[tid] & 15u) << 16;
  __syncthreads();

  // Each position's whole code, a position a thread, coalesced.
  const long long base = (long long)row * n_pos + (long long)chunk * kChunk;
  const int in_chunk = min(kChunk, n_pos - chunk * kChunk);
  for (int k = 0; k < kPer; ++k) {
    const int q = k * kThreads + tid;
    uint64_t c = 0;
    uint32_t m = 0;
    if (q < in_chunk) {
      const long long p = base + q;
      if (a.is_tok[p]) {
        const uint32_t e = s_ll[clampi(a.sym[p], kLL - 1)];
        c = e & 0xffffu;
        m = e >> 16;
      }
      if (a.is_match[p]) {
        const uint32_t le = s_len[clampi(a.len_idx[p], kLenCodes - 1)];
        const int di = clampi(a.dist_idx[p], kD - 1);
        const uint32_t de = s_d[di], dx = s_dist[di];
        const uint32_t l1 = le >> 16, l2 = de >> 16, l3 = dx >> 16;
        const uint64_t v1 =
            (uint64_t)(a.length[p] - (long long)(le & 0xffffu)) &
            ((1ull << l1) - 1);
        const uint64_t v3 =
            (uint64_t)(a.dist[p] - (long long)(dx & 0xffffu)) &
            ((1ull << l3) - 1);
        c |= v1 << m;
        m += l1;
        c |= (uint64_t)(de & 0xffffu) << m;
        m += l2;
        c |= v3 << m;
        m += l3;
      }
    }
    s_code[slot(q)] = c | (uint64_t)m << 56;
  }
  __syncthreads();

  // This thread's (count, tail) over its 16 positions.
  const int q0 = tid * kPer;
  Run mine = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const uint64_t e = s_code[slot(q0 + j)];
    const uint32_t m = (uint32_t)(e >> 56);
    const uint64_t c = e & ((1ull << 56) - 1);
    mine.t = append_tail(mine.t, c, m < 32 ? m : 32);
    if (m > 32) mine.t = append_tail(mine.t, c >> 32, m - 32);
    mine.n += m;
  }

  // Exclusive scan over the CTA's threads.
  Run inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Run o;
    o.n = __shfl_up_sync(0xffffffffu, inc.n, d);
    o.t = __shfl_up_sync(0xffffffffu, inc.t, d);
    if (lane >= d) inc = combine(o, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  Run excl;
  excl.n = __shfl_up_sync(0xffffffffu, inc.n, 1);
  excl.t = __shfl_up_sync(0xffffffffu, inc.t, 1);
  if (lane == 0) excl = Run{0u, 0u};
  __syncthreads();
  Run before_warp = {0u, 0u};
  for (int w = 0; w < warp; ++w) before_warp = combine(before_warp, s_warp[w]);
  excl = combine(before_warp, excl);

  // The chunk's prefix in its row: decoupled look-back, by warp 0.
  if (warp == 0) {
    Run agg = {0u, 0u};
    for (int w = 0; w < kWarps; ++w) agg = combine(agg, s_warp[w]);
    unsigned long long* my_flag = flags + (long long)row * nchunks + chunk;
    Run prefix = {0u, 0u};
    if (chunk == 0) {
      if (lane == 0) atomicExch(my_flag, flag_word(kPrefix, agg));
    } else {
      if (lane == 0) atomicExch(my_flag, flag_word(kAggregate, agg));
      // Lane i reads the flag of chunk - 1 - i.
      const bool mine_lane = lane < chunk;
      // A volatile read: the compiler may not keep the first one for the
      // loop (an asm load without side effects, such as __ldcv, it may).
      const volatile unsigned long long* f_at = my_flag - 1 - lane;
      unsigned long long f = 0;
      for (long long spins = 0;; ++spins) {
        f = mine_lane ? *f_at : 0ull;
        const unsigned pmask =
            __ballot_sync(0xffffffffu, mine_lane && (f >> 62) == 2);
        const unsigned okmask =
            __ballot_sync(0xffffffffu, mine_lane && (f >> 62) != 0);
        if (pmask) {
          const int j = __ffs(pmask) - 1;
          const unsigned need =
              j == 31 ? 0xffffffffu : ((1u << (j + 1)) - 1u);
          if ((okmask & need) == need) {
            // Combine lane j (the earliest, an inclusive prefix) .. lane 0.
            Run v = lane <= j ? flag_run(f) : Run{0u, 0u};
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              Run o;
              o.n = __shfl_down_sync(0xffffffffu, v.n, d);
              o.t = __shfl_down_sync(0xffffffffu, v.t, d);
              if (lane + d < 32) v = combine(o, v);
            }
            prefix.n = __shfl_sync(0xffffffffu, v.n, 0);
            prefix.t = __shfl_sync(0xffffffffu, v.t, 0);
            break;
          }
        }
        if (spins > kSpinLimit) __trap();
      }
      if (lane == 0) atomicExch(my_flag,
                                flag_word(kPrefix, combine(prefix, agg)));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const Run start = combine(s_prefix, excl);

  // This thread's words: those whose last bit lies in its range.
  const Out out{a.words + (long long)row * wn, wn};
  Acc acc;
  acc.n = (int)(start.n & 31u);
  acc.w = (int)(start.n >> 5);
  acc.a = acc.n ? (uint64_t)(start.t >> (32 - acc.n)) : 0ull;
#pragma unroll 4
  for (int j = 0; j < kPer; ++j) {
    const uint64_t e = s_code[slot(q0 + j)];
    acc.code(e & ((1ull << 56) - 1), (int)(e >> 56), out);
  }
  if (last_chunk && tid == kThreads - 1) {
    // The end-of-block code, the last partial word, total_bits.
    const uint32_t eob = s_ll[256];
    acc.put(eob & 0xffffu, (int)(eob >> 16), out);
    if (acc.n) out.store(acc.w++, (uint32_t)acc.a);
    a.total_bits[row] = (long long)start.n + mine.n + (eob >> 16);
    s_zero_from = acc.w;
  }
  __syncthreads();
  if (last_chunk)
    for (int i = s_zero_from + tid; i < wn; i += kThreads) out.w[i] = 0;

  // The CTA that finishes last leaves the scratch zero for the next launch.
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&counters[1], 1u) == (unsigned)(total_ctas - 1);
  }
  __syncthreads();
  if (s_last) {
    for (int i = tid; i < total_ctas; i += kThreads) flags[i] = 0ull;
    if (tid == 0) {
      counters[0] = 0u;
      counters[1] = 0u;
    }
  }
}

}  // namespace

extern "C" {

// One K8 launch: rows * ceil(n_pos / kChunk) CTAs of kThreads threads over
// args' inputs (every (G, N) pointer a contiguous device buffer, the tables'
// rows ll_stride and d_stride elements apart) into args' outputs. The
// scratch holds rows * nchunks + 1 zero uint64 words. n_pos must be at most
// kMaxChunks * kChunk.
int zt_pack_tokens(const PackArgs* args, int rows, int n_pos, int wn,
                   long long ll_stride, long long d_stride, void* stream,
                   int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (n_pos + kChunk - 1) / kChunk;
  if (nchunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (rows > 0 && nchunks > 0) {
    const int ctas = rows * nchunks;
    pack_tokens_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        *args, n_pos, wn, nchunks, ll_stride, d_stride, ctas);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
