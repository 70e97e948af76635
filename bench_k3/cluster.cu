// K3 (the crc32 row fold) as two designs measured against the kept one
// (zippy_tpu_torch/csrc/checksums.cu) by bench_k3_designs.py, which builds
// this file twice:
//   -DCOOP=0: one thread-block cluster of up to 16 blocks; each block's
//     sum times its meeting matrix (host columns by value) goes into
//     block 0's shared memory through distributed shared memory between
//     two cluster barriers;
//   -DCOOP=1: a cooperative grid of up to 128 blocks; the block sums go to
//     global memory, grid.sync(), and block 0 folds them by a log tree.
// Both: THREADS threads a block, byte tables (4 lookups of 256 words a
// map) staged in dynamic shared memory, the lattice and block tree of the
// kept design. levels: crc_shift_tables(27) as one uint32 buffer.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
namespace cg = cooperative_groups;

#ifndef THREADS
#define THREADS 256
#endif
#ifndef COOP
#define COOP 0
#endif
namespace {
constexpr int kTable = 1024;
constexpr int kThreads = THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kLgW = kWarps == 32 ? 5 : kWarps == 16 ? 4 : kWarps == 8 ? 3 : kWarps == 4 ? 2 : 1;
constexpr int kTreeLevels = 5 + kLgW;
constexpr int kRowLevel = 9;
constexpr int kBlockLevel = kRowLevel + kTreeLevels;
constexpr int kMaxLg = COOP ? 7 : 4;
constexpr int kBatch = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Meet { uint32_t col[COOP ? 1 : 16][32]; };

__device__ __forceinline__ uint32_t apply_tables(const uint32_t* t, uint32_t v) {
  return t[v & 0xFFu] ^ t[256 + ((v >> 8) & 0xFFu)] ^
         t[512 + ((v >> 16) & 0xFFu)] ^ t[768 + (v >> 24)];
}
__device__ __forceinline__ uint32_t fold_level(const uint32_t* tables, uint32_t v,
                                               int lane, int span) {
  const uint32_t right = __shfl_down_sync(kFull, v, span);
  return lane % (2 * span) == 0 ? apply_tables(tables, v) ^ right : v;
}

__global__ void __launch_bounds__(kThreads)
k3(const uint32_t* __restrict__ crcs, long long nrows, int lg,
   const uint4* __restrict__ levels, const __grid_constant__ Meet meet,
   uint32_t* __restrict__ sums, uint32_t* __restrict__ out) {
  extern __shared__ uint4 staged[];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ uint32_t parts[16];
  uint32_t* lv = reinterpret_cast<uint32_t*>(staged);
  const unsigned block = blockIdx.x;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
#if !COOP
  if (lg > 0) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
#endif
  const long long lanes = (long long)kThreads << lg;
  const long long nfull = nrows - 1;
  const long long steps = (nfull + lanes - 1) / lanes;
  const long long first = (long long)block * kThreads + t - (steps * lanes - nfull);
  const uint32_t last_row = block == 0 && t == 0 ? __ldg(crcs + nfull) : 0u;
  uint32_t batch[kBatch];
  auto load = [&](long long j0) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const long long i = first + (j0 + q) * lanes;
      batch[q] = j0 + q < steps && i >= 0 ? __ldg(crcs + i) : 0u;
    }
  };
  load(0);
  // staged: tree levels [0, kTreeLevels), then the Horner level, then (coop,
  // block 0) the meeting levels.
  constexpr int kV = kTable / 4;
  for (int i = t; i < kTreeLevels * kV; i += kThreads)
    staged[i] = __ldg(levels + kRowLevel * kV + i);
  if (steps > 1)
    for (int i = t; i < kV; i += kThreads)
      staged[kTreeLevels * kV + i] = __ldg(levels + (kBlockLevel + lg) * kV + i);
#if COOP
  if (block == 0)
    for (int i = t; i < lg * kV; i += kThreads)
      staged[(kTreeLevels + 1) * kV + i] = __ldg(levels + kBlockLevel * kV + i);
#endif
  __syncthreads();
  const uint32_t* horner = lv + kTreeLevels * kTable;
  uint32_t acc = 0;
  for (long long j0 = 0; j0 < steps; j0 += kBatch) {
    uint32_t rows[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) rows[q] = batch[q];
    if (j0 + kBatch < steps) load(j0 + kBatch);
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (j0 + q < steps) acc = (j0 + q ? apply_tables(horner, acc) : 0u) ^ rows[q];
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) acc = fold_level(lv + k * kTable, acc, lane, 1 << k);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int k = 0; k < kLgW; ++k)
      acc = fold_level(lv + (5 + k) * kTable, acc, lane, 1 << k);
  }
#if COOP
  if (t == 0) __stcg(sums + block, acc);
  if (lg > 0) cg::this_grid().sync();
  if (block == 0 && warp == 0) {
    const int nb = 1 << lg;
    const int per = nb > 32 ? nb / 32 : 1;
    const uint32_t* mt = lv + (kTreeLevels + 1) * kTable;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = q < per && lane * per + q < nb ? __ldcg(sums + lane * per + q) : 0u;
    int lev = 0;
#pragma unroll
    for (int s = 1; s < 4; s *= 2) {
      if (s < per) {
#pragma unroll
        for (int q = 0; q + s < 4; q += 2 * s) v[q] = apply_tables(mt + lev * kTable, v[q]) ^ v[q + s];
        ++lev;
      }
    }
    acc = v[0];
    for (int span = 1; span * per < nb; span *= 2, ++lev)
      acc = fold_level(mt + lev * kTable, acc, lane, span);
    const uint32_t sum = __shfl_sync(kFull, acc, 0);
    acc = __reduce_xor_sync(kFull, (sum >> lane) & 1u ? meet.col[0][lane] : 0u);
    if (lane == 0) *out = acc ^ last_row;
  }
#else
  if (warp == 0) {
    const uint32_t sum = __shfl_sync(kFull, acc, 0);
    acc = __reduce_xor_sync(kFull, (sum >> lane) & 1u ? meet.col[block][lane] : 0u);
  }
  if (lg > 0) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (t == 0) *cg::this_cluster().map_shared_rank(parts + block, 0) = acc;
    __syncwarp();
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  } else if (t == 0) {
    parts[0] = acc;
  }
  if (block == 0 && warp == 0) {
    __syncwarp();
    acc = __reduce_xor_sync(kFull, lane < (1 << lg) ? parts[lane] : 0u);
    if (lane == 0) *out = acc ^ last_row;
  }
#endif
}
}  // namespace

extern "C" int zt_threads() { return kThreads; }
extern "C" int zt_k3(const void* crcs, long long nrows, int lg, const void* levels,
                     const uint32_t* meet_cols, void* sums, void* out, void* stream) {
  if (lg > kMaxLg) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(kTreeLevels + 1 + (COOP ? kMaxLg : 0)) * kTable * 4;
  cudaError_t err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  Meet m = {};
  memcpy(m.col, meet_cols, sizeof(m.col) < (sizeof(uint32_t) * 32 << lg) ? sizeof(m.col)
                                                                           : (sizeof(uint32_t) * 32 << lg));
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1u << lg);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = &attr;
  config.numAttrs = lg > 0 ? 1 : 0;
#if COOP
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
#else
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1u << lg;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
#endif
  err = cudaLaunchKernelEx(&config, k3, (const uint32_t*)crcs, nrows, lg, (const uint4*)levels, m,
                           (uint32_t*)sums, (uint32_t*)out);
  if (err) return err;
  return cudaGetLastError();
}
