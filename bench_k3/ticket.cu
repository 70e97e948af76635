// K3 (the crc32 row fold) as a grid of up to 128 blocks that meet through
// a ticket, measured against the kept design (zippy_tpu_torch/csrc/
// checksums.cu) by bench_k3_designs.py: each block stores its part in
// global memory, __threadfence(), atomicAdd on the slot's ticket; the block
// that draws the last ticket fences again, reads and XORs the parts, and
// resets the ticket. -DNIB=1 gathers nibble tables from the byte tables
// while it stages (8 lookups of 16 words a map), -DNIB=0 stages the byte
// tables (4 lookups of 256 words). levels: crc_shift_tables(27).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#ifndef THREADS
#define THREADS 256
#endif
#ifndef NIB
#define NIB 1
#endif

namespace {
constexpr int kThreads = THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int lg2(int v) { return v > 1 ? 1 + lg2(v / 2) : 0; }
constexpr int kLgWarps = lg2(kWarps);
constexpr int kTreeLevels = 5 + kLgWarps;
constexpr int kRowLevel = 9;
constexpr int kBlockLevel = kRowLevel + kTreeLevels;
constexpr int kMaxLg = 7;
constexpr int kSlots = 64;
constexpr int kMap = NIB ? 128 : 1024;   // words per staged map
constexpr int kStaged = kTreeLevels + 1 + kMaxLg;
constexpr int kBatch = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ unsigned g_ticket[kSlots];
__device__ uint32_t g_parts[kSlots][1 << kMaxLg];

struct Cols { uint32_t c[32]; };

__device__ __forceinline__ uint32_t apply(const uint32_t* t, uint32_t v) {
#if NIB
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) r ^= t[16 * j + ((v >> (4 * j)) & 15u)];
  return r;
#else
  return t[v & 0xFFu] ^ t[256 + ((v >> 8) & 0xFFu)] ^
         t[512 + ((v >> 16) & 0xFFu)] ^ t[768 + (v >> 24)];
#endif
}

__device__ __forceinline__ uint32_t fold_level(const uint32_t* tables, uint32_t v,
                                               int lane, int span) {
  const uint32_t right = __shfl_down_sync(kFull, v, span);
  return lane % (2 * span) == 0 ? apply(tables, v) ^ right : v;
}

__global__ void __launch_bounds__(kThreads)
k3(const uint32_t* __restrict__ crcs, long long nrows, int lg,
   const uint32_t* __restrict__ levels, const __grid_constant__ Cols last_cols,
   int slot, uint32_t* __restrict__ out) {
#if NIB
  __shared__ uint32_t st[kStaged * kMap];
#else
  extern __shared__ uint32_t st[];
#endif
  __shared__ uint32_t warp_sums[kWarps];
  const unsigned block = blockIdx.x;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long lanes = (long long)kThreads << lg;
  const long long nfull = nrows - 1;
  const long long steps = (nfull + lanes - 1) / lanes;
  const long long first = (long long)block * kThreads + t - (steps * lanes - nfull);
  const uint32_t last_row = t == 0 ? __ldg(crcs + nfull) : 0u;
  uint32_t batch[kBatch];
  auto load = [&](long long j0) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const long long i = first + (j0 + q) * lanes;
      batch[q] = j0 + q < steps && i >= 0 ? __ldg(crcs + i) : 0u;
    }
  };
  load(0);
  const int nst = kTreeLevels + 1 + lg;
  for (int w = t; w < nst * kMap; w += kThreads) {
    const int s = w / kMap, within = w % kMap;
    const int level = s < kTreeLevels ? kRowLevel + s
                      : s == kTreeLevels ? kBlockLevel + lg
                                         : kBlockLevel + (s - kTreeLevels - 1);
#if NIB
    const int j = within / 16, e = within % 16;
    st[w] = __ldg(levels + level * 1024 + (j >> 1) * 256 + ((j & 1) ? e << 4 : e));
#else
    st[w] = __ldg(levels + level * 1024 + within);
#endif
  }
  __syncthreads();
  const uint32_t* horner = st + kTreeLevels * kMap;
  uint32_t acc = 0;
  for (long long j0 = 0; j0 < steps; j0 += kBatch) {
    uint32_t rows[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) rows[q] = batch[q];
    if (j0 + kBatch < steps) load(j0 + kBatch);
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (j0 + q < steps) acc = (j0 + q ? apply(horner, acc) : 0u) ^ rows[q];
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) acc = fold_level(st + k * kMap, acc, lane, 1 << k);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp != 0) return;
  acc = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
  for (int k = 0; k < kLgWarps; ++k)
    acc = fold_level(st + (5 + k) * kMap, acc, lane, 1 << k);
  // lane 0: the block's sum, shifted over the blocks after it.
  const unsigned after = (1u << lg) - 1 - block;
  for (int k = 0; k < lg; ++k)
    if ((after >> k) & 1) acc = apply(st + (kTreeLevels + 1 + k) * kMap, acc);
  bool last = true;
  if (lg > 0) {
    unsigned ticket = 0;
    if (lane == 0) {
      g_parts[slot][block] = acc;
      __threadfence();
      ticket = atomicAdd(&g_ticket[slot], 1u);
    }
    last = __shfl_sync(kFull, ticket, 0) == (1u << lg) - 1;
    if (!last) return;
    __threadfence();
    uint32_t v = 0;
    for (int b = lane; b < (1 << lg); b += 32) v ^= __ldcg(&g_parts[slot][b]);
    acc = v;
    if (lane == 0) g_ticket[slot] = 0;
  }
  const uint32_t sum = __reduce_xor_sync(kFull, lane == 0 || lg > 0 ? acc : 0u);
  acc = __reduce_xor_sync(kFull, (sum >> lane) & 1u ? last_cols.c[lane] : 0u);
  if (lane == 0) *out = acc ^ __ldg(crcs + nfull);
  (void)last_row;
}
}  // namespace

extern "C" int zt_k3(const void* crcs, long long nrows, int lg, const void* levels,
                     const uint32_t* cols, int slot, void* out, void* stream) {
  if (lg > kMaxLg || slot < 0 || slot >= kSlots) return cudaErrorInvalidValue;
  Cols c;
  memcpy(c.c, cols, sizeof(c.c));
  size_t smem = NIB ? 0 : (size_t)kStaged * kMap * 4;
  if (!NIB) {
    cudaError_t err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  k3<<<1u << lg, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)crcs, nrows, lg, (const uint32_t*)levels, c, slot, (uint32_t*)out);
  return cudaGetLastError();
}
