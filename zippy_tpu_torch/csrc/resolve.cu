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
//    `start` with distance d reads start - d + (o mod d), clamped to the
//    output. Such reads chain across tokens, always to earlier bytes, and
//    end at a literal, a stored byte or the halo.
//
//    Bound: the bytes (tokens 4 k a lane, the stored sources, the halo and
//    the output, about 5 MB for a CFG_L tile of 4 MiB, 1.5 us at 3.35
//    TB/s). The chase is the hard part: chains run to thousands of hops on
//    repetitive data, and a hop is a dependent load, so each match byte
//    follows its chain by pointer doubling, log2(depth) rounds of one
//    gather a byte, with a grid-wide barrier (a launch boundary) between
//    rounds.
//    Design, 2 + max(nrounds, 1) launches a tile:
//    1. fill: out[0 .. HALO) = halo, out[HALO .. HALO + used) = 0, and
//       link[0 .. used) = -1, the "resolved" mark of every tile byte.
//    2. expand: one warp a busy lane, 8 lanes a CTA. Lane t of the warp
//       loads token t (k <= 32 a pass), a warp scan of the lengths gives
//       each token's start, and the warp then walks the lane's output 32
//       bytes at a time: each thread finds its byte's token by a binary
//       search over the 32 running sums (five shuffles), writes a
//       literal's byte, or a match byte's source position into link. The
//       writes of one step are 32 consecutive bytes and ints. One more
//       CTA per stored-span slot copies its span. The XLA version's match
//       compaction (gathers cost ~90 M/s on the TPU) and its 9 shifted
//       selects are not needed: link is indexed by output position.
//    3. nrounds rounds over the tile's bytes: a match byte whose source is
//       itself an unresolved match byte takes that byte's link, in place.
//       In place is sound: a link only ever moves further down its chain,
//       and every link points strictly earlier, so a round reads values at
//       least as far along as the previous round left them. The last round
//       also writes each match byte's value, out[link] when that is
//       resolved (out[0] otherwise, as the plain version's clamp does).
//    link is scratch of `used` int32 that the wrapper allocates through
//    torch. Every write stays inside its buffer whatever the tokens and
//    seg_out hold (a corrupt stream or a hostile index): expand and chase
//    touch only the tile's bytes [HALO, HALO + used) and their links, and
//    a stored span only out[0 .. out_pad).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"

namespace {

constexpr int kHalo = 32768;
constexpr int kStoMax = 1 << 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(const uint8_t* __restrict__ halo, int used,
            uint8_t* __restrict__ out, int32_t* __restrict__ link) {
  const int j = (int)(blockIdx.x * kThreads + threadIdx.x);
  if (j < kHalo) {
    out[j] = halo[j];
  } else if (j < kHalo + used) {
    out[j] = 0;
    link[j - kHalo] = -1;
  }
}

// One stored span (slot s of the table): the plain version's clamps.
__device__ __forceinline__ void copy_stored(const int32_t* __restrict__ sto,
                                            int nsto, int s,
                                            const uint8_t* __restrict__ bytes,
                                            int nbytes, int out_pad,
                                            uint8_t* __restrict__ out) {
  const int src = min(max(__ldg(sto + s), 0), nbytes);
  const int o0 = min(max(__ldg(sto + nsto + s), 0), out_pad);
  const int ln = max(0, min(min(__ldg(sto + 2 * nsto + s), kStoMax),
                            out_pad - o0));
  const int n = min(ln, nbytes - src);
  for (int x = (int)threadIdx.x; x < ln; x += kThreads)
    out[o0 + x] = x < n ? __ldg(bytes + src + x) : 0;
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int32_t* __restrict__ packed, long long ld, int lanes,
              int k, const int32_t* __restrict__ seg_out,
              const uint8_t* __restrict__ bytes, int nbytes,
              const int32_t* __restrict__ sto, int nsto, int lane_ctas,
              int used, int out_pad, uint8_t* __restrict__ out,
              int32_t* __restrict__ link) {
  if ((int)blockIdx.x >= lane_ctas) {
    copy_stored(sto, nsto, (int)blockIdx.x - lane_ctas, bytes, nbytes,
                out_pad, out);
    return;
  }
  const int t = (int)threadIdx.x & 31;
  const int lane = (int)blockIdx.x * kWarps + ((int)threadIdx.x >> 5);
  if (lane >= lanes) return;  // the whole warp
  // 64-bit positions: seg_out and the lengths are the stream's to choose.
  long long base = __ldg(seg_out + lane);
  for (int g = 0; g < k; g += 32) {
    const int i = g + t;
    const int32_t tok = i < k ? __ldg(packed + (long long)i * ld + lane) : 0;
    const int len = (int)((uint32_t)tok >> 16);
    const int low = tok & 0xFFFF;
    // Inclusive sum of the lengths: token t's bytes are offsets
    // [incl - len, incl) from base.
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, o);
      if (t >= o) incl += v;
    }
    const int total = __shfl_sync(kAll, incl, 31);
    for (int c = 0; c < total; c += 32) {
      const int q = c + t;
      // The byte's token: the number of tokens whose bytes end at or
      // before q (at most 31 while q < total; tokens of length 0 never
      // hold a byte).
      int j = 0;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        if (__shfl_sync(kAll, incl, j + s - 1) <= q) j += s;
      const int end = __shfl_sync(kAll, incl, j);
      const int tlen = __shfl_sync(kAll, len, j);
      const int tlow = __shfl_sync(kAll, low, j);
      if (q >= total) continue;
      const long long start = base + end - tlen;
      const int o = q - (end - tlen);
      const long long pos = start + o;
      // Bytes past the tile's `used` are padding that no caller reads, and
      // link holds `used` ints: tokens that run on (a corrupt stream) stop.
      if (pos < kHalo || pos >= kHalo + used) continue;
      if (tlow < 256) {
        out[pos] = (uint8_t)tlow;
      } else if (tlow > 256) {
        const int d = tlow - 256;
        link[pos - kHalo] = (int)min(max(start - d + o % d, 0LL),
                                     (long long)out_pad - 1);
      }
      // A distance of 0 (no real stream has one): a zero byte, resolved.
    }
    base += total;
  }
}

// One doubling round over the tile's bytes (hop), and with `finish` the
// value of each match byte.
__global__ void __launch_bounds__(kThreads)
chase_kernel(int used, bool hop, bool finish, int32_t* __restrict__ link,
             uint8_t* __restrict__ out) {
  const int j = (int)(blockIdx.x * kThreads + threadIdx.x);
  if (j >= used) return;
  int p = link[j];
  if (p < 0) return;  // a literal, a stored byte or a resolved 0
  // Whether position p is resolved: the halo, or a tile byte whose link
  // is -1. Links of match bytes stay >= 0, so other threads' hops in this
  // round never change the answer.
  const auto resolved = [&](int x) {
    return x < kHalo || (x < kHalo + used && link[x - kHalo] < 0);
  };
  if (hop && p >= kHalo && p < kHalo + used) {
    const int q = link[p - kHalo];
    if (q >= 0) {
      p = q;
      link[j] = q;
    }
  }
  if (finish) out[kHalo + j] = resolved(p) ? out[p] : out[0];
}

}  // namespace

extern "C" {

// packed: k rows of `lanes` int32, row i at packed + i * ld; seg_out: lanes
// int32; words: nwords int32 of the tile's stream (read as bytes); sto: 3
// rows of nsto int32 (source byte, output position, length); halo: HALO
// bytes; out: out_pad = HALO + tile_out bytes (out[0 .. HALO + used) is
// written); link: max(used, 1) int32 of scratch. *launched counts the
// kernels this call launched.
int zt_lz_resolve(const void* packed, long long ld, int lanes, int k,
                  const void* seg_out, const void* words, int nwords,
                  const void* sto, int nsto, const void* halo, int used,
                  int out_pad, int nrounds, void* out, void* link,
                  void* stream, int device, int* launched) {
  *launched = 0;
  DeviceScope scope;
  cudaError_t err = scope.enter(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  uint8_t* o = (uint8_t*)out;
  int32_t* l = (int32_t*)link;

  fill_kernel<<<blocks_for((long long)kHalo + used), kThreads, 0, s>>>(
      (const uint8_t*)halo, used, o, l);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int lane_ctas = (lanes + kWarps - 1) / kWarps;
  expand_kernel<<<lane_ctas + nsto, kThreads, 0, s>>>(
      (const int32_t*)packed, ld, lanes, k, (const int32_t*)seg_out,
      (const uint8_t*)words, 4 * nwords, (const int32_t*)sto, nsto,
      lane_ctas, used, out_pad, o, l);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rounds = nrounds > 0 ? nrounds : 1;
  const int grid = used > 0 ? blocks_for(used) : 1;
  for (int r = 0; r < rounds; ++r) {
    chase_kernel<<<grid, kThreads, 0, s>>>(used, r < nrounds,
                                           r == rounds - 1, l, o);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
