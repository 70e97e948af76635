// Hand-written Hopper (sm_90a) kernels for the device decode's LZ
// resolution.
//
// Built by zippy_tpu_torch/ops/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: the entry point takes raw device pointers and the
// caller's stream, launches the kernels of one tile in order on that stream,
// allocates nothing, never waits for the card, and returns the first CUDA
// error it met (0 when every launch was accepted).
//
// K6 zt_lz_resolve replaces the jnp/XLA `_resolve`
//    (zippy_tpu/ops/inflate_device.py:359) with `_ffill_span` (:340). It
//    writes one tile's output, out[0 .. HALO + used), from
//    - the tile's tokens as K4 packs them, packed[i][lane] = out_len << 16 |
//      literal or out_len << 16 | (dist + 256), 0 past the lane's tokens;
//    - seg_out[lane], the output position of the lane's first token;
//    - the stored-span table (source byte in the tile's words, output
//      position, length; empty slots of length 0);
//    - the halo, the 32 KiB of output before the tile, at out[0 .. HALO).
//    A literal is its byte; a stored span a copy of its bytes (clamped to
//    the words and to STO_MAX, zeros past the words); byte o of a match at
//    `start` with distance d reads start - d + (o mod d), clamped to
//    [0, out_pad - 1]. Such reads chain across tokens, always to earlier
//    bytes, and end at a literal, a stored byte or the halo.
//
//    Bound: the bytes (tokens 4 k a lane, the stored sources, the halo and
//    the output, about 5 MB for a CFG_L tile of 4 MiB, 1.5 us at 3.35
//    TB/s). The chase is the hard part: chains run to thousands of hops on
//    repetitive data, and a hop is a dependent load, so each match byte
//    follows its chain by pointer doubling, log2(depth) rounds of one
//    gather a byte, with a launch boundary between rounds.
//
//    Every tile byte has one int32 state: a match byte's link (the position
//    its value comes from, >= 0, always before it) while it is open, or
//    ~value (< 0) once resolved. A hop sets an open byte's state to the
//    state of its link: the link's value when that is resolved, else the
//    link's own link (doubling). A halo position is resolved, its value
//    out[p]. In place is sound: a state only ever moves further down its
//    chain (or to the chain's value), and every link points strictly
//    earlier, so a hop reads states at least as far along as the round
//    before left them. The last round also finishes: a byte whose link is
//    still open looks it up once more, and takes out[0]'s value if that is
//    open too, as the plain version's clamp reads out[0] for a source it
//    did not resolve.
//
//    Design, 1 + rounds_for(nrounds, hops) launches a tile
//    (resolve_kernels.launches_per_tile):
//    1. expand: kExpandLanes busy lanes a CTA, kStoCtas CTAs for the
//       stored spans, kHaloCtas for the halo. Every tile byte that a token
//       or span covers is written once: its state, and for a literal or a
//       stored byte its value in out. No fill: a position that nothing
//       covers (a corrupt stream) keeps whatever its scratch held, and the
//       rounds check every link they follow, so that its value is garbage
//       but every read stays inside the tile. A CTA shares its lanes'
//       bytes out evenly over its threads: a lane of 32 matches of 258
//       bytes holds 8,256 bytes, a lane of literals 32.
//    2. rounds over every tile byte, each taking up to `hops` hops a byte
//       (3 for a CFG_L tile, 7 up to a CFG_S tile's 256 KiB): h hops
//       multiply a byte's reach down its chain by h + 1, so that
//       rounds_for(nrounds, 2^b - 1) = ceil(nrounds / b) rounds reach as
//       far as the plain version's nrounds doubling rounds. A byte writes
//       its value to out when it resolves; the last round writes out[0]'s
//       value for the bytes still open.
//    Tried on the H100 and not kept, both slower than the multi-launch
//    design they were to replace: one launch of a thread-block cluster
//    for every tile of up to 256 KiB, the states in distributed shared
//    memory (a cluster round, a cluster barrier and a dependent DSMEM
//    load, costs about what a launch costs, and at most 16 SMs do the
//    lookups), and rounds over a worklist of the bytes still open (on
//    text nearly every match byte is still open after a round, so the
//    list saved no reads and cost its appends).
//    Writes stay inside the tile's bytes [HALO, HALO + used) and their
//    states, and out[0 .. HALO) (the halo, where a stored span of a
//    corrupt table may land, as in the plain version), whatever the tokens
//    and seg_out hold (a corrupt stream or a hostile index).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kHalo = 32768;
constexpr int kStoMax = 1 << 16;
constexpr unsigned kAll = 0xffffffffu;

constexpr int kThreads = 256;
constexpr int kExpandLanes = 8;      // busy lanes a CTA expands
constexpr int kStoCtas = 32;         // CTAs for the stored spans
constexpr int kHaloCtas = 8;         // 4 KiB of the halo each
// Rounds: a small tile's (up to kSmallTile bytes, every CFG_S tile) take
// kSmallHops hops, one byte a thread, and are bound by their launches and
// their hops' latency; a larger tile's take kLargeHops, kPer bytes a
// thread, and are bound by the L2 sectors their lookups read. Each is the
// fastest of those timed in turns on the H100: 1, 3 and 7 hops; 1, 4 and
// 8 bytes a thread.
constexpr int kSmallTile = 1 << 18;
constexpr int kSmallHops = 7;
constexpr int kLargeHops = 3;
constexpr int kPer = 4;

static_assert(kHaloCtas * kThreads * 16 == kHalo, "16 halo bytes a thread");

// The inputs of one tile, as zt_lz_resolve takes them.
struct Tile {
  const int32_t* packed;
  long long ld;
  int lanes;
  int k;
  const int32_t* seg_out;
  const uint8_t* bytes;  // the tile's stream words, read as bytes
  int nbytes;
  const int32_t* sto;
  int nsto;
  const uint8_t* halo;
  int used;
  int out_pad;
  int nrounds;
  uint8_t* out;
};

// Rounds of `hops` hops each that reach at least as far down every chain
// as nrounds doubling rounds: h hops a round multiply a byte's reach by
// h + 1 (each hop reads a state at least as far along as the round before
// left it), so that hops = 2^b - 1 makes b doubling rounds of each.
int rounds_for(int nrounds, int hops) {
  const int b = hops >= 7 ? 3 : hops >= 3 ? 2 : 1;
  return nrounds > 0 ? (nrounds + b - 1) / b : 1;
}

// One CTA's lanes' tokens in shared memory, for expand_lanes.
struct LaneShared {
  int incl[kExpandLanes][32];  // inclusive sums of a lane's token lengths
  int low[kExpandLanes][32];   // literal, or distance + 256
  long long base[kExpandLanes];
  int start[kExpandLanes + 1];  // each lane's first byte among the CTA's
};

// Calls put(j, state) for each byte of busy lanes [l0, l0 + nl) (nl <=
// kExpandLanes) inside the tile, j = pos - HALO in [0, used): a literal's
// ~byte, a match byte's link, a distance 0's ~0. Every thread of the CTA
// calls it. Each warp loads a
// lane's 32 tokens (a pass of k) and scans their lengths; then the lanes'
// bytes are shared out evenly over the CTA's threads, each finding its
// byte's lane and token by binary searches in shared memory: one lane of 32
// matches of 258 bytes costs no more than 8,256 bytes spread over lanes.
template <typename Put>
__device__ void expand_lanes(const Tile& a, int l0, int nl, LaneShared& sh,
                             Put put) {
  const int tid = (int)threadIdx.x, t = tid & 31, warp = tid >> 5;
  const int nwarps = (int)blockDim.x >> 5;
  for (int w = warp; w < nl; w += nwarps)
    if (t == 0) sh.base[w] = __ldg(a.seg_out + l0 + w);
  for (int g = 0; g < a.k; g += 32) {
    for (int w = warp; w < nl; w += nwarps) {
      const int i = g + t;
      const int32_t tok =
          i < a.k ? __ldg(a.packed + (long long)i * a.ld + l0 + w) : 0;
      int incl = (int)((uint32_t)tok >> 16);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kAll, incl, o);
        if (t >= o) incl += v;
      }
      sh.incl[w][t] = incl;
      sh.low[w][t] = tok & 0xFFFF;
    }
    __syncthreads();
    if (tid == 0) {
      sh.start[0] = 0;
      for (int w = 0; w < nl; ++w)
        sh.start[w + 1] = sh.start[w] + sh.incl[w][31];
    }
    __syncthreads();
    const int total = sh.start[nl];
    for (int q = tid; q < total; q += (int)blockDim.x) {
      // The byte's lane: the last one that starts at or before q.
      int lo = 0, hi = nl;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (sh.start[mid] <= q) lo = mid; else hi = mid;
      }
      const int qq = q - sh.start[lo];
      // Its token: the number of tokens whose bytes end at or before qq.
      int j = 0;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        if (sh.incl[lo][j + s - 1] <= qq) j += s;
      const int end = sh.incl[lo][j];
      const int tlen = end - (j ? sh.incl[lo][j - 1] : 0);
      const int tlow = sh.low[lo][j];
      const long long start = sh.base[lo] + end - tlen;
      const int o = qq - (end - tlen);
      const long long pos = start + o;
      // Bytes past the tile's `used` are padding that no caller reads, and
      // the states cover `used` bytes: tokens that run on (a corrupt
      // stream) stop.
      if (pos < kHalo || pos >= kHalo + a.used) continue;
      int32_t s;
      if (tlow < 256) {
        s = ~tlow;
      } else if (tlow > 256) {
        // The source, start - d + (o mod d) clamped to the output: always
        // before pos, so chains only run back.
        const int d = tlow - 256;
        s = (int32_t)min(max(start - d + o % d, 0LL),
                         (long long)a.out_pad - 1);
      } else {
        s = ~0;  // a distance of 0 (no real stream has one): a zero byte
      }
      put((int)(pos - kHalo), s);
    }
    __syncthreads();
    for (int w = tid; w < nl; w += (int)blockDim.x)
      sh.base[w] += sh.incl[w][31];
    __syncthreads();
  }
}

// The plain version's clamps of stored-span slot s: its source byte, its
// first output position and its length, and how many of its bytes the
// words hold (the rest are zeros).
struct Span {
  int src, o0, ln, n;
};

__device__ __forceinline__ Span stored_span(const Tile& a, int s) {
  Span p;
  p.src = min(max(__ldg(a.sto + s), 0), a.nbytes);
  p.o0 = min(max(__ldg(a.sto + a.nsto + s), 0), a.out_pad);
  p.ln = max(0, min(min(__ldg(a.sto + 2 * a.nsto + s), kStoMax),
                    a.out_pad - p.o0));
  p.n = min(p.ln, a.nbytes - p.src);
  return p;
}

// Calls put(pos, byte) for each byte of every stored span, the spans
// spread over `nthreads` threads (this one is t0), 16 bytes a thread a
// step: the 16 loads are issued before any put, and a warp's threads take
// neighbouring bytes. Each warp's ballot finds the slots that hold a span.
template <typename Put>
__device__ __forceinline__ void stored_bytes(const Tile& a, int t0,
                                             int nthreads, Put put) {
  for (int c0 = 0; c0 < a.nsto; c0 += 32) {
    const int slot = c0 + ((int)threadIdx.x & 31);
    unsigned some = __ballot_sync(
        kAll, slot < a.nsto && __ldg(a.sto + 2 * a.nsto + slot) > 0);
    while (some) {
      const Span p = stored_span(a, c0 + __ffs(some) - 1);
      some &= some - 1;
      for (int x0 = t0; x0 < p.ln; x0 += 16 * nthreads) {
        uint8_t v[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int x = x0 + b * nthreads;
          v[b] = x < p.n ? __ldg(a.bytes + p.src + x) : 0;
        }
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (x0 + b * nthreads < p.ln) put(p.o0 + x0 + b * nthreads, v[b]);
      }
    }
  }
}

// out[16 c .. 16 c + 16) = the halo's bytes: 16 loads, one 16-byte store
// (out is 16-aligned; the halo, a view into the previous tile's output, is
// not).
__device__ __forceinline__ void halo_chunk(const Tile& a, int c) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    w[b >> 2] |= (uint32_t)__ldg(a.halo + 16 * c + b) << (8 * (b & 3));
  reinterpret_cast<uint4*>(a.out)[c] = make_uint4(w[0], w[1], w[2], w[3]);
}

// kN states advanced `hops` hops and, with `finish`, finished: every
// look(p) of a step is issued before any of the next. s[q] < 0 for a
// position that is resolved or has none.
template <int kN, typename Look>
__device__ __forceinline__ void advance(int32_t (&s)[kN], int hops,
                                        bool finish, int32_t zero,
                                        Look look) {
  for (int h = 0; h < hops; ++h) {
    bool any = false;
#pragma unroll
    for (int q = 0; q < kN; ++q)
      if (s[q] >= 0) {
        s[q] = look(s[q]);
        any = true;
      }
    if (!any) break;
  }
  if (finish) {
#pragma unroll
    for (int q = 0; q < kN; ++q)
      if (s[q] >= 0) {
        const int32_t v = look(s[q]);
        s[q] = v < 0 ? v : zero;
      }
  }
}

// ---------------------------------------------------------------------------
// The kernels: an expansion, then rounds over the tile's bytes.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    expand_kernel(Tile a, int lane_ctas, int32_t* __restrict__ state) {
  __shared__ LaneShared lsh;
  const int b = (int)blockIdx.x, tid = (int)threadIdx.x;
  if (b < lane_ctas) {
    const int l0 = b * kExpandLanes;
    expand_lanes(a, l0, min(kExpandLanes, a.lanes - l0), lsh,
                 [&](int j, int32_t s) {
                   state[j] = s;
                   if (s < 0) a.out[kHalo + j] = (uint8_t)~s;
                 });
    return;
  }
  if (b < lane_ctas + kStoCtas) {
    stored_bytes(a, (b - lane_ctas) * kThreads + tid, kStoCtas * kThreads,
                 [&](int pos, uint8_t v) {
                   if (pos < kHalo) {
                     a.out[pos] = v;  // a corrupt table's span in the halo
                   } else if (pos < kHalo + a.used) {
                     a.out[pos] = v;
                     state[pos - kHalo] = ~(int32_t)v;
                   }
                 });
    return;
  }
  // The halo, 16 bytes a thread; where a stored span reaches into it (only
  // a corrupt table has one), byte by byte, its bytes winning as in the
  // plain version.
  const int c = (b - lane_ctas - kStoCtas) * kThreads + tid;
  int hit = 0;
  for (int s = tid; s < a.nsto; s += kThreads) {
    const Span p = stored_span(a, s);
    hit |= p.ln > 0 && p.o0 < kHalo;
  }
  if (!__syncthreads_or(hit)) {
    halo_chunk(a, c);
    return;
  }
  for (int x = 16 * c; x < 16 * c + 16; ++x) {
    bool covered = false;
    for (int s = 0; s < a.nsto && !covered; ++s) {
      const Span p = stored_span(a, s);
      covered = x >= p.o0 && x < p.o0 + p.ln;
    }
    if (!covered) a.out[x] = __ldg(a.halo + x);
  }
}

// One round over the tile's bytes, kN a thread: each open byte takes
// `hops` hops and, in the last round, finishes; a byte that resolves
// writes its value to out.
template <int kN>
__global__ void __launch_bounds__(kThreads)
    round_kernel(int used, int hops, bool finish, int32_t* state,
                 uint8_t* out) {
  const int j0 = (int)blockIdx.x * kThreads * kN + (int)threadIdx.x;
  // The state of position p: the halo's value (out[0 .. HALO), written by
  // the expansion), else tile byte p's state. A link must point before
  // its byte; one that does not is a byte that nothing covered (a corrupt
  // stream: no fill wrote its scratch), taken as a resolved 0, so that
  // every read stays inside the tile.
  const auto look = [&](int32_t p) -> int32_t {
    if (p < kHalo) return ~(int32_t)out[p];
    const int32_t q = state[p - kHalo];
    return q >= p ? ~0 : q;
  };
  int32_t s[kN];
  unsigned was = 0;
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const int j = j0 + q * kThreads;
    s[q] = j < used ? state[j] : -1;
    if (s[q] >= kHalo + j) s[q] = -1;  // nothing covered it: see look
    was |= (unsigned)(s[q] >= 0) << q;
  }
  if (!was) return;
  advance(s, hops, finish, ~(int32_t)out[0], look);
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    if (!(was >> q & 1)) continue;
    const int j = j0 + q * kThreads;
    state[j] = s[q];
    if (s[q] < 0) out[kHalo + j] = (uint8_t)~s[q];
  }
}

}  // namespace

extern "C" {

// packed: k rows of `lanes` int32, row i at packed + i * ld; seg_out: lanes
// int32; words: nwords int32 of the tile's stream (read as bytes); sto: 3
// rows of nsto int32 (source byte, output position, length); halo: HALO
// bytes; out: out_pad = HALO + tile_out bytes, 16-aligned (out[0 .. HALO +
// used) is written); state: max(used, 1) int32 of scratch. *launched counts
// the kernels this call launched.
int zt_lz_resolve(const void* packed, long long ld, int lanes, int k,
                  const void* seg_out, const void* words, int nwords,
                  const void* sto, int nsto, const void* halo, int used,
                  int out_pad, int nrounds, void* out, void* state,
                  void* stream, int device, int* launched) {
  *launched = 0;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const Tile a{(const int32_t*)packed, ld, lanes, k,
               (const int32_t*)seg_out, (const uint8_t*)words, 4 * nwords,
               (const int32_t*)sto, nsto, (const uint8_t*)halo, used,
               out_pad, nrounds, (uint8_t*)out};
  int32_t* st = (int32_t*)state;
  uint8_t* o = (uint8_t*)out;

  const int lane_ctas = (lanes + kExpandLanes - 1) / kExpandLanes;
  expand_kernel<<<lane_ctas + kStoCtas + kHaloCtas, kThreads, 0, s>>>(
      a, lane_ctas, st);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const bool small = used <= kSmallTile;
  const int hops = small ? kSmallHops : kLargeHops;
  const int rounds = rounds_for(nrounds, hops);
  const int per = small ? 1 : kPer;
  const int grid = used > 0 ? (used + kThreads * per - 1) / (kThreads * per)
                            : 1;
  for (int r = 0; r < rounds; ++r) {
    const int h = nrounds > 0 ? hops : 0;
    if (small)
      round_kernel<1><<<grid, kThreads, 0, s>>>(used, h, r == rounds - 1,
                                                st, o);
    else
      round_kernel<kPer><<<grid, kThreads, 0, s>>>(used, h, r == rounds - 1,
                                                   st, o);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
