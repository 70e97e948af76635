// Hand-written Hopper (sm_90a) kernel for the device decode's token
// extraction.
//
// Built by zippy_tpu_torch/ops/kernel_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: the entry point takes raw device pointers and the
// caller's stream, launches one kernel, allocates nothing, and returns the
// first CUDA error it met (0 when the launch was accepted).
//
// K4 zt_inflate_extract replaces the jnp/XLA `_extract`
//    (zippy_tpu/ops/inflate_device.py:268) with `_cmp_decode` (:246) and
//    `_rev15` (:152). Every segment lane of a tile decodes up to k
//    sequential DEFLATE tokens from its bit offset, with the Huffman tables
//    of its block, and writes them packed as the reference does:
//      out[i][lane] = out_len << 16 | literal       (a literal)
//                   = out_len << 16 | (dist + 256)  (a match)
//                   = 0                             (i >= ntok)
//    Tables, per block, 382 int32 (ops/inflate_kernels.TABLE_WORDS): the
//    Moffat boundaries fc = first + count and rank offsets off = rank_base
//    - first per code length, and the rank -> entry row E, for the litlen
//    code (16, 16, 288) and the distance code (16, 16, 30).
//
//    Bound: the bytes, mostly the packed output (8 MB for a CFG_L tile; a
//    token decode needs only 13-31 operations), and in practice the
//    latency of dependent steps. Each step needs the bit position the step
//    before it produced, so a lane is a chain of k dependent decodes: three
//    word loads, then 14 boundary compares, an offset load and an entry
//    load for the litlen code, the same again for the distance code.
//    Design: one thread per lane, the block's tables read through the
//    read-only cache (a tile's tables are at most 64 x 1.5 KB, so they stay
//    in L1/L2), and the 64-bit window made from three consecutive words by
//    two funnel shifts. The TPU version's half-shifted copy of the words
//    (which saved it one gather a step) and its one-hot reduces (which
//    avoided gathers) are not needed here. Lanes are independent, so the
//    latency hides only behind other lanes: a 4 MiB tile has about 30,000
//    busy lanes for the card's 270,000 thread slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Offsets inside one block's table row (int32 words).
constexpr int kFcL = 0;
constexpr int kOffL = 16;
constexpr int kEL = 32;
constexpr int kNL = 288;
constexpr int kFcD = kEL + kNL;     // 320
constexpr int kOffD = kFcD + 16;    // 336
constexpr int kED = kOffD + 16;     // 352
constexpr int kND = 30;
constexpr int kTableWords = kED + kND;  // 382

constexpr int kThreads = 128;

// Canonical Huffman decode by comparisons (Moffat): `r` is the bit-reversed
// 15-bit window (MSB-first code space). The code length is 1 + the number of
// exceeded boundaries; the symbol's entry is E[code + off[len]], 0 for a
// rank outside the row.
__device__ __forceinline__ int32_t cmp_decode(const int32_t* __restrict__ t,
                                              int fc, int off, int e, int n,
                                              int32_t r, int32_t* cl_out) {
  int32_t cl = 1;
#pragma unroll
  for (int len = 1; len <= 14; ++len)
    cl += (r >> (15 - len)) >= __ldg(t + fc + len) ? 1 : 0;
  const int32_t rank = (r >> (15 - cl)) + __ldg(t + off + cl);
  *cl_out = cl;
  return (rank >= 0 && rank < n) ? __ldg(t + e + rank) : 0;
}

__global__ void __launch_bounds__(kThreads)
inflate_extract_kernel(const uint32_t* __restrict__ words, int nwords,
                       const int32_t* __restrict__ seg_bit,
                       const int32_t* __restrict__ seg_blk,
                       const int32_t* __restrict__ seg_ntok, int nseg,
                       const int32_t* __restrict__ tables, int nblk, int k,
                       int32_t* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= nseg) return;
  int32_t bit = seg_bit[lane];
  const int32_t ntok = seg_ntok[lane];
  const int32_t blk = min(max(seg_blk[lane], 0), nblk - 1);
  const int32_t* __restrict__ t = tables + (long long)blk * kTableWords;
  for (int i = 0; i < k; ++i) {
    int32_t val = 0;
    if (i < ntok) {
      // 64 stream bits from `bit` on: three words (index clamped to the
      // buffer), two funnel shifts.
      const int iw = min(max(bit >> 5, 0), nwords - 1);
      const uint32_t w0 = __ldg(words + iw);
      const uint32_t w1 = __ldg(words + min(iw + 1, nwords - 1));
      const uint32_t w2 = __ldg(words + min(iw + 2, nwords - 1));
      const uint32_t sh = (uint32_t)bit & 31u;
      const uint32_t lo = __funnelshift_r(w0, w1, sh);
      const uint32_t hi = __funnelshift_r(w1, w2, sh);
      // Litlen symbol: rev15 of the low 15 bits is brev(lo) >> 17.
      int32_t cl;
      const int32_t e = cmp_decode(t, kFcL, kOffL, kEL, kNL,
                                   (int32_t)(__brev(lo) >> 17), &cl);
      const bool is_lit = (e >> 5) & 1;
      const int32_t lb = (e >> 8) & 0xFF;
      const int32_t lbase = (e >> 16) & 0x1FF;
      const uint32_t lx = (uint32_t)(e >> 25) & 7u;
      const int32_t length =
          lbase + (int32_t)((lo >> cl) & ((1u << lx) - 1u));
      // Distance symbol: its code starts cl + lx bits in (1..22).
      const uint32_t sh2 = (uint32_t)cl + lx;
      const uint32_t lo2 = __funnelshift_r(lo, hi, sh2);
      int32_t dcl;
      const int32_t de = cmp_decode(t, kFcD, kOffD, kED, kND,
                                    (int32_t)(__brev(lo2) >> 17), &dcl);
      const uint32_t dx = (uint32_t)(de >> 5) & 15u;
      const int32_t dist = ((de >> 16) & 0x7FFF) + 1 +
                           (int32_t)((lo2 >> dcl) & ((1u << dx) - 1u));
      if (is_lit) {
        val = (1 << 16) | lb;
        bit += cl;
      } else {
        val = (length << 16) | (dist + 256);
        bit += (int32_t)(sh2 + (uint32_t)dcl + dx);
      }
    }
    out[(long long)i * nseg + lane] = val;
  }
}

}  // namespace

extern "C" {

// words: nwords >= 1 uint32 (the tile's stream words); seg_bit, seg_blk,
// seg_ntok: nseg int32 each (bit offset into words, block row, tokens);
// tables: nblk >= 1 rows of 382 int32; out: k * nseg int32, row i holding
// every lane's token i.
int zt_inflate_extract(const void* words, int nwords, const void* seg_bit,
                       const void* seg_blk, const void* seg_ntok, int nseg,
                       const void* tables, int nblk, int k, void* out,
                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nseg > 0 && k > 0) {
    const int grid = (nseg + kThreads - 1) / kThreads;
    inflate_extract_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, nwords, (const int32_t*)seg_bit,
        (const int32_t*)seg_blk, (const int32_t*)seg_ntok, nseg,
        (const int32_t*)tables, nblk, k, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
