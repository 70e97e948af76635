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
//    of its word k / 32; words (G, Wn = N / 2 + 8) int32 hold the uint32
//    values' bit patterns, zero past the row's last bit; total_bits (G,)
//    int64.
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
//    Design: one launch. The row's positions are cut into chunks of
//    kChunk = 4096 (a 55-row group of 64 KiB blocks is 880 chunks), and a
//    CTA of kThreads = 256 works through chunks taken from a ticket
//    counter. The grid is the CTAs the card holds at once (two an SM at
//    kMinCtas), so that each CTA loads its next chunk while it scans and
//    writes this one: the time of a chunk is set by round trips (the
//    loads, the look-back, the stores), and a CTA a chunk spends them
//    one after another.
//    - A thread owns kPer = 16 consecutive positions, the positions whose
//      bits it scans and writes. Its two bools arrive as two 16-byte vector
//      loads (bit j of `tm`, `mm`: position j is a token, a match). A
//      thread whose positions run past the row, or whose bools are not
//      16-byte aligned (a row base that is not, since N is the caller's),
//      reads them a byte at a time instead: the same masks, by the scalar
//      path.
//    - The fields are loaded by lanes, not owners: lane l of warp w loads
//      the chunk positions 512 w + 32 k + l (k = 0..15), its masks taken
//      from the owners' by shuffles, so that neighbouring lanes read
//      neighbouring positions (owners reading their own 16 positions make
//      a warp's load touch 32 lines; bench_torch_pack_tables.py times the
//      loads alone both ways). Every load of the lane is started before any
//      is used, predicated, fully unrolled into registers: the 16 symbols
//      (on its token bits) and the four fields of its first kMatchBatch
//      matches (a further round takes any more).
//      A load reads the low 32 bits of its int64 field (every value fits:
//      symbols < 286, indexes < 30, lengths <= 258, distances <= 32768; an
//      index is clamped as an int32), one register a position in flight.
//      A 32-byte sector that holds no token (no match) is never read for
//      `sym` (the match fields): chip_smoke.pack_work counts exactly those
//      sectors. Not cp.async into shared memory: the copies would be of 4
//      bytes each, and the owners would compute each code twice, once for
//      the scan and once for the words, from shared memory.
//    - Each lane writes the whole code of each position it loaded to
//      shared memory, the four components concatenated into one value of
//      at most 48 bits (the constant tables' extra lengths are at most 5
//      and 13) with its length in the top byte; the owners read them.
//    - Each owner sums the lengths of its 16 positions and keeps the last
//      32 bits of its own stream (its "tail"). (count, tail) pairs combine
//      associatively, (a, b) -> (a.n + b.n, b.n >= 32 ? b.t : a.t >> b.n |
//      b.t), so one scan over the CTA's threads gives each its start bit
//      in the chunk and the 32 bits before it, and the chunk's aggregate.
//    - Chunks meet by decoupled look-back: a chunk is taken by ticket (so
//      every chunk before it is held by a CTA that already runs, and is
//      the next chunk that CTA works on or one it finished), publishes its
//      aggregate, and one warp reads the flags of the chunks before it in
//      its row at once (a row has at most kMaxChunks = 32), combining
//      aggregates back to the nearest inclusive prefix; then it publishes
//      its own inclusive prefix. Each flag is one 64-bit word (status << 62
//      | count << 32 | tail), written whole.
//    - Each owner then writes exactly the words whose last bit lies in its
//      bit range, by plain stores: it starts its 64-bit accumulator with
//      the bits of its first word that lie before it (from the tail before
//      it), appends its codes, and stores a word each time 32 bits are
//      full. A word that its range does not fill is finished by a later
//      thread, which holds its first bits in that tail. So no word is
//      written twice, and there are no atomics on the words. Words are
//      int32 with the uint32 bit pattern, the form the host's splice reads
//      (deflate_device._finish_fetch views them as "<u4"), so no pass
//      converts them after K8.
//    - The row's last chunk appends the end-of-block code, stores the last
//      partial word, writes total_bits, and zeroes the words past the
//      stream with its whole CTA, by 16-byte stores between a scalar head
//      and tail.
//    - The look-back's flags and the two counters (tickets, CTAs that
//      left) live in a scratch buffer per stream (pack_kernels._scratch),
//      zero before a launch. A CTA leaves after taking the one ticket past
//      the last chunk, so the CTA that leaves last knows no ticket will be
//      taken again, and zeroes them. A CTA that has read a flag kSpinLimit
//      = 2^24 times without the prefix traps (a fault, not a hang).

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
  int32_t* words;              // (G, Wn), uint32 bit patterns
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
// CTAs an SM that the registers must leave room for (ptxas then keeps a
// thread within 65536 / (kThreads * kMinCtas) registers).
constexpr int kMinCtas = 2;
// Devices whose resident CTA count the entry point keeps.
constexpr int kMaxDevices = 64;
// Matches a lane loads in one round. A lane's 16 positions lie 32 apart,
// and few of them are matches (about 8% of positions at level 6), so one
// round nearly always takes them all; more take further rounds.
constexpr int kMatchBatch = 6;
// A lane loads the positions of its warp's span that are kStride apart.
constexpr int kStride = 32;
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
  int32_t* w;
  int wn;
  __device__ __forceinline__ void store(int i, uint32_t v) const {
    if (i < wn) w[i] = (int32_t)v;
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

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// Bit k of the result: byte k of the four is not zero.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t mask16(uint4 v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
         nibble(v.w) << 12;
}

// The low 32 bits of an int64 field at positions p0 + kStride * k whose
// bit k of `mask` is set, all started before any is used; 0 where the bit
// is clear.
__device__ __forceinline__ void load_lo(const long long* __restrict__ f,
                                        long long p0, uint32_t mask,
                                        uint32_t (&v)[kPer]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(f + p0);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    v[k] = (mask >> k & 1u) ? __ldg(w + 2 * kStride * k) : 0u;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The low 32 bits of an int64 field.
__device__ __forceinline__ uint32_t ld_lo(const long long* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// A lane's next kMatchBatch matches: their k (bit k of `rest`, which
// loses them; -1 past its last; the match is at position p0 + kStride *
// k) and their four fields' low words, every load started before any is
// used.
struct Matches {
  int k[kMatchBatch];
  uint32_t li[kMatchBatch], di[kMatchBatch], len[kMatchBatch],
      dist[kMatchBatch];
  __device__ __forceinline__ void take(const PackArgs& a, long long p0,
                                       uint32_t& rest) {
#pragma unroll
    for (int i = 0; i < kMatchBatch; ++i) {
      k[i] = rest ? __ffs(rest) - 1 : -1;
      rest &= rest - 1u;
    }
#pragma unroll
    for (int i = 0; i < kMatchBatch; ++i) {
      const bool ok = k[i] >= 0;
      const long long p = p0 + (ok ? kStride * k[i] : 0);
      li[i] = ok ? ld_lo(a.len_idx + p) : 0u;
      di[i] = ok ? ld_lo(a.dist_idx + p) : 0u;
      len[i] = ok ? ld_lo(a.length + p) : 0u;
      dist[i] = ok ? ld_lo(a.dist + p) : 0u;
    }
  }
};

// A chunk's bools as they arrive: two 16-byte vector loads where the
// thread's 16 positions lie in the row and are 16-byte aligned (`vec`),
// else read a byte at a time when the masks are made.
struct Bools {
  uint4 t, m;
  long long p0;  // the thread's first position, flat
  int left;      // positions of the row from p0 on (may be <= 0)
  bool vec;
  __device__ __forceinline__ void start(const PackArgs& a, int ticket,
                                        int n_pos, int nchunks, int q0) {
    const int row = ticket / nchunks, chunk = ticket % nchunks;
    // No clamp of `left` to 0..kPer: ptxas fused one into a VIMNMX.RELU
    // whose predicate took the vector path at left = 0 and 1, reading the
    // next row's bools.
    left = n_pos - chunk * kChunk - q0;
    p0 = (long long)row * n_pos + (long long)chunk * kChunk + q0;
    vec = left >= kPer && aligned16(a.is_tok + p0) &&
          aligned16(a.is_match + p0);
    if (vec) {
      t = __ldg(reinterpret_cast<const uint4*>(a.is_tok + p0));
      m = __ldg(reinterpret_cast<const uint4*>(a.is_match + p0));
    }
  }
};

// A chunk's loads in flight: the owner's masks (bit j: its position j is
// a token, a match), the lane's token mask, the symbols of its tokens,
// its first kMatchBatch matches, and its share of the row's code tables
// (symbols tid and tid + kThreads of the litlen code, symbol tid of the
// distance code).
struct Pending {
  int ticket;
  long long p0, lp0;   // the owner's first position; the lane's (k = 0)
  uint32_t ltm, rest;
  uint32_t sym[kPer];
  Matches mt;
  uint32_t ll_len[2], ll_code[2], d_len, d_code;

  __device__ __forceinline__ void start(const PackArgs& a, const Bools& b,
                                        int tkt, int nchunks,
                                        long long ll_stride,
                                        long long d_stride, int tid) {
    ticket = tkt;
    p0 = b.p0;
    uint32_t tm = 0u, mm = 0u;
    if (b.vec) {
      tm = mask16(b.t);
      mm = mask16(b.m);
    } else {
      const uint8_t* t8 = reinterpret_cast<const uint8_t*>(a.is_tok);
      const uint8_t* m8 = reinterpret_cast<const uint8_t*>(a.is_match);
      for (int j = 0; j < kPer; ++j) {
        if (j < b.left) {
          tm |= (uint32_t)(t8[p0 + j] != 0) << j;
          mm |= (uint32_t)(m8[p0 + j] != 0) << j;
        }
      }
    }
    // Lane l of warp w loads the chunk positions 512 w + 32 k + l (k =
    // 0..15), its masks (bit k) from the owners' by shuffles.
    const int lane = tid & 31;
    uint32_t lt = 0u, lm = 0u;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int owner = 2 * k + (lane >> 4);
      lt |= (__shfl_sync(0xffffffffu, tm, owner) >> (lane & 15) & 1u) << k;
      lm |= (__shfl_sync(0xffffffffu, mm, owner) >> (lane & 15) & 1u) << k;
    }
    ltm = lt;
    lp0 = p0 - tid * kPer + (tid >> 5) * kStride * kPer + lane;
    load_lo(a.sym, lp0, lt, sym);
    rest = lm;
    mt.take(a, lp0, rest);
    const int row = tkt / nchunks;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = tid + k * kThreads;
      const bool ok = s < kLL;
      ll_len[k] = ok ? ld_lo(a.ll_lens + row * ll_stride + s) : 0u;
      ll_code[k] = ok ? ld_lo(a.ll_codes + row * ll_stride + s) : 0u;
    }
    d_len = tid < kD ? ld_lo(a.d_lens + row * d_stride + tid) : 0u;
    d_code = tid < kD ? ld_lo(a.d_codes + row * d_stride + tid) : 0u;
  }
};

__global__ void __launch_bounds__(kThreads, kMinCtas)
pack_tokens_kernel(PackArgs a, int n_pos, int wn, int nchunks,
                   long long ll_stride, long long d_stride, int total) {
  __shared__ uint64_t s_code[kSlots];  // code | length << 56
  __shared__ uint32_t s_ll[kLL];      // code | length << 16
  __shared__ uint32_t s_d[kD];
  __shared__ uint32_t s_len[kLenCodes];   // base | extra << 16
  __shared__ uint32_t s_dist[kD];
  __shared__ Run s_warp[kWarps];
  __shared__ Run s_prefix;
  __shared__ int s_ticket, s_zero_from, s_last;

  unsigned long long* flags = a.scratch;
  unsigned int* counters = reinterpret_cast<unsigned int*>(a.scratch + total);
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = tid * kPer;

  // The constant tables, once; the first two tickets.
  if (tid < kD)
    s_dist[tid] = ((uint32_t)a.base_dist[tid] & 0xffffu) |
                  ((uint32_t)a.dist_extra[tid] & 15u) << 16;
  if (tid < kLenCodes)
    s_len[tid] = ((uint32_t)a.base_len[tid] & 0xffffu) |
                 ((uint32_t)a.len_extra[tid] & 15u) << 16;
  if (tid == 0) s_ticket = (int)atomicAdd(&counters[0], 1u);
  __syncthreads();
  // A CTA that starts late may find every chunk taken.
  const int first = s_ticket;
  Bools nb;
  Pending p;
  int next = total;
  if (first < total) {
    nb.start(a, first, n_pos, nchunks, q0);
    p.start(a, nb, first, nchunks, ll_stride, d_stride, tid);
  }
  __syncthreads();
  if (tid == 0 && first < total) s_ticket = (int)atomicAdd(&counters[0], 1u);
  __syncthreads();
  if (first < total) next = s_ticket;
  if (next < total) nb.start(a, next, n_pos, nchunks, q0);

  while (first < total) {
    const int row = p.ticket / nchunks, chunk = p.ticket % nchunks;
    const bool last_chunk = chunk == nchunks - 1;
    // The row's code tables.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = tid + k * kThreads;
      const uint32_t n = p.ll_len[k] & 15u;
      if (s < kLL) s_ll[s] = (n ? p.ll_code[k] & 0xffffu : 0u) | n << 16;
    }
    if (tid < kD) {
      const uint32_t n = p.d_len & 15u;
      s_d[tid] = (n ? p.d_code & 0xffffu : 0u) | n << 16;
    }
    __syncthreads();

    // Each loaded position's whole code in shared memory: its litlen code,
    // then each match's length extra bits, distance code and distance
    // extra bits appended.
    const int lq0 = warp * kStride * kPer + lane;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t e =
          (p.ltm >> k & 1u) ? s_ll[clampi((int)p.sym[k], kLL - 1)] : 0u;
      s_code[slot(lq0 + kStride * k)] =
          (e & 0xffffu) | (uint64_t)(e >> 16) << 56;
    }
    for (;;) {
#pragma unroll
      for (int i = 0; i < kMatchBatch; ++i) {
        if (p.mt.k[i] < 0) continue;
        uint64_t& code = s_code[slot(lq0 + kStride * p.mt.k[i])];
        uint64_t c = code & ((1ull << 56) - 1);
        uint32_t m = (uint32_t)(code >> 56);
        const uint32_t le = s_len[clampi((int)p.mt.li[i], kLenCodes - 1)];
        const int d = clampi((int)p.mt.di[i], kD - 1);
        const uint32_t de = s_d[d], dx = s_dist[d];
        const uint32_t l1 = le >> 16, l2 = de >> 16, l3 = dx >> 16;
        const uint64_t v1 =
            (p.mt.len[i] - (le & 0xffffu)) & ((1u << l1) - 1u);
        const uint64_t v3 =
            (p.mt.dist[i] - (dx & 0xffffu)) & ((1u << l3) - 1u);
        c |= v1 << m;
        m += l1;
        c |= (uint64_t)(de & 0xffffu) << m;
        m += l2;
        c |= v3 << m;
        m += l3;
        code = c | (uint64_t)m << 56;
      }
      if (!p.rest) break;
      p.mt.take(a, p.lp0, p.rest);
    }
    // The owner of 16 positions reads codes that its warp's lanes wrote.
    __syncwarp();
    const bool more = next < total;
    const int this_ticket = p.ticket;
    // The next chunk's loads, in flight while this one is scanned and
    // written.
    if (more) p.start(a, nb, next, nchunks, ll_stride, d_stride, tid);

    // This thread's (count, tail) over its 16 positions.
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

    // Exclusive scan over the CTA's threads; the ticket after next taken
    // meanwhile.
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
    if (tid == 0 && more) s_ticket = (int)atomicAdd(&counters[0], 1u);
    __syncthreads();
    const int after = more ? s_ticket : total;
    if (after < total) nb.start(a, after, n_pos, nchunks, q0);
    Run before_warp = {0u, 0u};
    for (int w = 0; w < warp; ++w)
      before_warp = combine(before_warp, s_warp[w]);
    excl = combine(before_warp, excl);

    // The chunk's prefix in its row: decoupled look-back, by warp 0.
    if (warp == 0) {
      Run agg = {0u, 0u};
      for (int w = 0; w < kWarps; ++w) agg = combine(agg, s_warp[w]);
      unsigned long long* my_flag = flags + this_ticket;
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
              // Combine lane j (the earliest, an inclusive prefix) .. 0.
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
        if (lane == 0)
          atomicExch(my_flag, flag_word(kPrefix, combine(prefix, agg)));
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
    if (last_chunk) {
      // Words s_zero_from .. wn - 1 zeroed: a scalar head up to a 16-byte
      // boundary, 16-byte stores, a scalar tail.
      const int from = min(s_zero_from, wn);
      const int head = min(
          wn, from + (int)((16u - (reinterpret_cast<uintptr_t>(out.w + from) &
                                   15u)) & 15u) / 4);
      const int n4 = (wn - head) / 4;
      const int tail = head + 4 * n4;
      if (tid < head - from) out.w[from + tid] = 0;
      uint4* v = reinterpret_cast<uint4*>(out.w + head);
      for (int i = tid; i < n4; i += kThreads) v[i] = make_uint4(0, 0, 0, 0);
      if (tid < wn - tail) out.w[tail + tid] = 0;
    }
    if (!more) break;
    next = after;
    // s_code, s_ll and s_d are rewritten for the next chunk.
    __syncthreads();
  }

  // The CTA that leaves last (each CTA leaves after the ticket that ran
  // past the end, so no CTA takes one after this) leaves the scratch zero
  // for the next launch.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&counters[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    for (int i = tid; i < total; i += kThreads) flags[i] = 0ull;
    if (tid == 0) {
      counters[0] = 0u;
      counters[1] = 0u;
    }
  }
}

}  // namespace

extern "C" {

// One K8 launch: as many CTAs of kThreads threads as the card holds at
// once, at most one a chunk, over rows * ceil(n_pos / kChunk) chunks of
// args' inputs (every (G, N) pointer a contiguous device buffer, the tables'
// rows ll_stride and d_stride elements apart) into args' outputs (words
// int32, Wn a row). The scratch holds rows * nchunks + 1 zero uint64 words.
// n_pos must be at most kMaxChunks * kChunk.
int zt_pack_tokens(const PackArgs* args, int rows, int n_pos, int wn,
                   long long ll_stride, long long d_stride, void* stream,
                   int device) {
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (n_pos + kChunk - 1) / kChunk;
  if (nchunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (rows > 0 && nchunks > 0) {
    const int total = rows * nchunks;
    // The CTAs the card holds at once, found once a device.
    static int resident[kMaxDevices];
    if (device < 0 || device >= kMaxDevices)
      return (int)cudaErrorInvalidDevice;
    if (resident[device] == 0) {
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pack_tokens_kernel, kThreads, 0);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
      if (err != cudaSuccess) return (int)err;
      resident[device] = max(1, per_sm * sms);
    }
    const int ctas = min(total, resident[device]);
    pack_tokens_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        *args, n_pos, wn, nchunks, ll_stride, d_stride, total);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
